#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Print the card's name and power limit; build the CUDA kernels from
   ``distributedratelimiting/redis_tpu_torch/csrc`` (one ``nvcc`` per source,
   in parallel) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes: ``sweep_expired`` over 2^24 slots (and
   the TTL-saturation case), ``acquire_packed`` and ``acquire_grouped`` at
   B = 4096 with Zipf-like duplicates, and the bulk lane's
   ``acquire_scan_packed`` on one chunk of K = 32 batches of 4096 (Zipf(1.2)
   slots duplicated within and across batches, 2% padding, three ticks)
   with the fused u8 operand (bits out and f32 out) and the i32 operand
   (counts up to 1000), and on a chunk of distinct slots within each batch
   (the main path's bulk); the counter kernels ``sync_counters`` at B = 2^20
   (Zipf(1.1) slots with duplicates, 2% padding, half the counters live,
   ticks on both sides of the stored ones; distinct slots), B = 8, 32, 33,
   4,096 and 2^17 Zipf rows, slot 0 both a real slot and the padding rows'
   read (B = 4,096 and 2^17), whole-number sums at B = 4,096, 2^17 and
   2^20, each shape launched twice on clones of the table (bit-equal), and
   ``sweep_counters`` over 2^20 counters (each sync shape's times ride on
   the kernels line; ``--sync-bench`` times the sync and the debit at the
   store's shapes, warm and with the L2 flushed, and ``sweep_counters``,
   the whole function, at 1 to 2^20 + 7 counters held to its plain version,
   on the package beside the script: ``python3 chip_smoke.py
   --sync-bench``); the window kernels on a
   window
   table of 2^24 slots: ``window_packed`` and ``window_grouped`` at B =
   4096 with duplicates, ``window_scan_packed`` on one chunk of K = 32 x
   4096 (distinct and Zipf slots, the fused and the i32 lane, sliding and
   fixed, ticks crossing a window boundary), ``sweep_windows`` over 2^24
   slots; both bulk-lane scans (buckets; sliding and fixed windows) on
   2^24-slot tables at the shapes the chunks above leave out: a chunk of
   keys distinct in the whole chunk (the main path's bulk), one slot taking
   all 32 x 4096 rows, 4,096 slots repeated in all 32 batches at a tick of
   their own (one going back), and the coalescing lane's K = 1 launch of a
   4096-row operand with three valid rows, each with its event ms, device
   ms and bound (``--scan-bench`` runs these and the chunks above alone,
   after the bulk lane's one-batch chunks on their three routes — the scan
   padded to 4,096 rows, the scan padded to its rows, and the flush the
   store sends them to — at 8 to 4,096 distinct and Zipf(1.2) rows, bucket
   and window, each against its plain version: ``python3 chip_smoke.py
   --scan-bench``, or a copy of the script in another checkout to time
   that checkout's kernels); the semaphore kernels
   the four flush kernels (``acquire_packed``, ``acquire_grouped``,
   ``window_packed``, ``window_grouped``) on 2^24-slot tables at the
   shapes the store launches: one valid row at B = 8 (and at B = 4096, as
   the parent's store padded it), 12, 32, 64, 256 and 2,048 Zipf rows,
   4,096 Zipf rows and 4,096 distinct slots, each with its
   event ms, device ms and bound (``--flush-bench`` runs these alone, as
   ``--scan-bench`` does its shapes); the semaphore kernels
   ``sema_packed`` at B = 8 and B = 4096
   (repeated slots, acquires, releases, probes, padding, out-of-range slots)
   over 2^20 slots and ``sweep_semas`` over 2^20 (held slots survive);
   ``acquire_hierarchical`` at B = 4096 on the LLM workload's rows, with its
   own budgets and with both budgets binding, and at one valid row of B = 8
   (a reserve's shape); ``debit_packed`` at B = 2^20
   distinct slots of a 2^24 table, at B = 4096 with repeats, fractional and
   negative amounts, with whole-number repeats at 4,096 and 2^17, and one
   valid row at B = 8, each launched twice on clones (bit-equal). Grants,
   bits, masks, ``exists``, ``last_ts``, counter replies and periods and
   debit replies must be equal; every flush result and state field equal
   (one writer a slot applies its int64 consumption once); elsewhere
   remaining and tokens within atol 1e-4; counter values and debit tokens
   equal for distinct slots and whole numbers and, where a slot takes r > 1
   fractional adds, within r spacings of its float32 value (the plain
   version's adds on the card are atomic; the kernels round each slot's
   exact sum once); every window result and state field equal
   (whole-number counts). The bench's kernels at its widths, each against
   its plain version on a CPU copy of the same 10M-slot table:
   ``acquire_scan_packed24`` at 32 x 8192 (two launches; uniform slots as
   the bench sends, and Zipf(1.2); 2% ``SLOT24_PAD``, 1% ids >= N),
   ``acquire_scan_compact_fused`` at 16 x 8192 (one launch; count 1, and
   Zipf with counts 0-3), ``acquire_batch`` at B = 8192 and at B = 8 and 64
   with Zipf repeats, with and without the duplicate serialization (the
   latter beside the flush on the same rows with prefix 0, which must
   decide alike): grants, remaining and integer state equal, tokens equal
   (without the serialization within r spacings for r rows of a slot).
   Time each (median of CUDA-event timings, and device time from
   ``torch.profiler``) beside the plain version and the bound.
3. The main path at full size: ``PartitionedRateLimiter`` over
   ``DeviceBucketStore(device="cuda", n_slots=2**24)`` — ``acquire_many``
   over 10,000,000 distinct keys, a bulk chunk of new keys under
   ``torch.profiler`` before it (its device busy share and kernel
   launches; the trace must hold the kernel) and one after it (the same
   reading, or "not measured" where the trace holds no kernel, ROADMAP
   C1),
   concurrent ``acquire_async`` on hot and cold keys checked against a host
   oracle (cap-5 bucket × 32 asks → 5), the tier-0 debit (``debit_many`` of
   float amounts on 1,000,000 of the table's keys in one launch, then a
   refund, both held to a host float32 oracle), then ``sweep_all`` past the
   TTL with an exact eviction count. Every table resolves keys through the
   native key directory (checked). Each phase prints its rate and where its
   host time went (the store's dispatch spans, the key directory, Python's
   garbage collector).
4. The approximate path, 1M keys, Zipf(1.1) (BASELINE.json config 3), on a
   second store with ``counter_slots=2**20``: one ``sync_counters_many``
   over 1,000,000 distinct keys (one launch; every score equals its count),
   16 rounds of 2^18 Zipf(1.1) draws pre-aggregated per key and one round
   left unaggregated, each reply checked against a host float32 oracle of
   the decay; eight ``ApproximateTokenBucketRateLimiter``s sharing one
   counter at a staggered cadence (the instance estimate reaches 8, grants
   per period stay within the limit plus the staleness bound); then
   ``sweep_all`` a day later evicts exactly the live counters. Prints the
   fleet sync's counters/s and its host split.
5. The window path, BASELINE config 4 ("sliding-window counter variant,
   10M keys, bursty Poisson arrivals"), on a store of its own (2^24 window
   slots): ``PartitionedWindowRateLimiter`` with a sliding window of 100
   permits a second, ``acquire_many`` over 10,000,000 distinct keys (one
   ``window_scan`` launch per chunk) and 1M of them again with remaining;
   40 steps of Poisson arrivals on a ManualClock (10x bursts, half of a
   burst on 64 hot keys) through ``acquire_async`` (``window_packed``,
   ``window_grouped``), every key's grants held to a host float32 serial
   oracle of the sliding-window rule; cap-5 x 32 -> 5 and readmission after
   roll-off, sliding and fixed; ``sweep_all`` evicting exactly every slot.
   ``python3 chip_smoke.py --window-traffic [--gc-freeze]`` runs this path
   alone (the arrivals' collector passes counted by generation;
   ``--gc-freeze`` freezes the older objects before the arrivals).
6. The admission path, on a store of its own (2^18 bucket slots, 2^20
   semaphore slots): ``concurrency_acquire_many`` of 1 permit on 1,000,000
   distinct keys and their release (one ``sema_packed`` launch per 4,096
   rows), a batch whose keys mix releases with other rows (the one-op-at-a-
   time hazard route), ``ConcurrencyLimiter(permit_limit=5)`` with 32
   concurrent acquires (exactly 5 leases, the waiters failed by dispose, a
   second limiter on the same ``instance_name``), ``sweep_all`` a day later
   (exactly the zero-held slots go); then two-level admission on the LLM
   workload (``benchmarks/llm_workload.py:63-91``, copied; 2^16 rows as
   ``benchmarks/recapture.py:143-170`` runs it): ``acquire_hierarchical_many``
   with the workload's budgets (16 launches), a binding arm (tenant budget
   5e4 tokens, the clock 10 ticks on before each 2,048-row window) in which
   a third or more of the rows are denied and every tenant stays within
   budget plus refill, and ``AdmissionPolicy.acquire`` on 2,048 rows; all
   grants equal, row by row, to the port's CPU store on the same clock
   schedule, and the rows within float rounding of a threshold counted.
7. The reservation path (the estimate-reserve-settle lane,
   ``runtime/reservations.py``) at ``benchmarks/recapture.py:174-214``'s
   size: 8,192 LLM-workload rows reserved at cost x LogNormal(0, 0.55)
   estimates and settled at their costs, serially through the ledger of a
   2^16-slot card store (``max_batch`` 1024; one ``acquire_hierarchical``
   launch a reserve, ``debit_packed`` launches for refunds, overages and
   debt), one tick a row; pairs/s, settled tokens/s, refund and debt
   ratios, where a pair's time goes (store awaits, host dispatch,
   readback, the ledger) and, from a profiled sample, its device time;
   the same schedule on the port's CPU store (grants, outcomes, counters
   and debtors equal, floats within 2 float32 spacings of the tenant
   budget); the zero-fill audit arm (``benchmarks/llm_workload.py:
   325-362``: 8,000 rows, tenant budget 20,000, fill 1e-9; ``net_drift``
   <= 0.01 and the perfect-estimate oracle's bound); 1,000 pairs through
   ``BucketStoreServer`` and the port's ``RemoteBucketStore`` (retried
   reserves and settles debit nothing twice, an unknown rid, ``OP_STATS``'
   section equal to the server's ledger); a TTL auto-settle on an injected
   ledger clock.
8. The checkpoint path (the serial store and incremental checkpoints; at
   BASELINE size): the serial ``InProcessBucketStore`` and a card
   ``DeviceBucketStore`` of 2^24 slots on one ManualClock schedule —
   1,000,000 Zipf(1.1) bucket draws in 8 bulk calls (limit 100, 10 tokens/s,
   one count a call), 4,096 ``acquire_async``, 65,536 two-level rows (calls
   of 4,096 distinct tenants and keys), a ``debit_many`` of 2^16 keys, 2^16
   fixed-window draws: grants equal, ``remaining`` and the debit's replies
   equal (a denied row after an earlier denied row of its key in one
   decision may read the card's conservative 0), every entry's state equal;
   then a ``BucketStoreServer(snapshot_incremental=True)`` over a card store
   of 2^24 slots holding 2,000,000 bucket keys (cut from 10,000,000 to
   4,000,000 when the fp path joined, and to 2,000,000 when the drain path
   did: the script must end within 1,200 s), 1,000,000
   sliding-window keys, 2^16 counters and 2^16 held semaphores: ``OP_SAVE`` (a base), 500,000
   keys again and 10,000 new ones (``dirty_stats`` 510,000), ``OP_SAVE``
   (delta 1, under a tenth of the base), ``OP_SAVE`` (dirty 0; an empty
   delta 2), the chain restored into a fresh card store equal to the saving
   store array for array and key for key, cap-5 x 32 -> 5 on a restored
   drained key; a day later ``sweep_all`` and ``OP_SAVE`` (a delta or a
   compacting base, printed), restored equal again. Each save's seconds and
   bytes, the store lock's longest hold during it, the load's seconds. The
   console entry point with ``--snapshot-incremental`` on ``--backend
   inprocess`` and ``--backend device``, the latter restarted on its chain
   (``(+2 deltas)``); the bench's ``nproc``, ``serving_p99_colocated`` and
   ``serving_p99_instant`` sections once each with short windows (no key
   null). ``python3 chip_smoke.py --paths checkpoint`` runs this path
   alone (``--paths`` takes any of the paths of phases 3–10 and 12–20,
   comma-separated).
9. The observability and overload plane (``--paths observability``), at
   the server cell's size: ``BucketStoreServer(observability=True,
   metrics_port=0, flight_dir=<tmp>, audit=AuditConfig(tick_s=0.05),
   overflow_pool=...)`` over a card ``DeviceBucketStore`` of 2^24 slots.
   From a client process of its own (``chip_smoke.py --obs-client``),
   50,000 ``acquire``s, one frame each, 64 tasks, Zipf(1.1) over 1M keys;
   the heavy-hitter sketch's top 64 (``OP_METRICS``'s ``hot_key_*``
   families, ``OP_STATS``' top 10 their head) held to the stream's exact
   counts (``count - error <= true`` for all 64; present, and ``true <=
   count``, for every key above N/64); then the 10M-key bulk as
   ``ACQUIRE_MANY`` frames, ``/metrics`` scraped every 0.5 s all the while
   and parsed; ``OP_METRICS`` after it equal to the server's own counters
   (requests, connections, shed, store launches and rows, retries, the
   sketch's weight, the serving histogram's count). ``OP_TRACES`` at sample
   1.0 for 200 requests: Chrome JSON with ``server.*`` spans under their
   client's trace ids. ``start_device_trace`` / ``stop_device_trace``
   around a 1M-key bulk on a card store, in a process of its own
   (``chip_smoke.py --obs-device-trace``): ``drl/`` ranges, and every
   kernel in the trace launched inside one. One flush failure injected at the
   ``store.flush`` seam: exactly one ``flush_error`` dump, JSONL holding
   the flush frames. The audit: no breach over 20 ticks and more of the
   traffic above; the JAX test's seeded leak soak on a card store: one
   bundle within three ticks. The doomed-work and retry-shed gates armed
   (JAX's words; the store untouched) and the overflow-pool redirect of
   ``OP_RESERVE``. A seeded storm (``storm_schedule``) with faults on the
   client's and the server's seams: cap-5 x 32 -> 5, every rid held and
   settled once. The plane's cost: the same 50,000 requests in ABBA
   blocks against this server and one with ``observability=False`` over a
   store of its own: requests/s and p99 each way, printed, not asserted.
10. The shared store server (README "Multi-host", BASELINE config 2's
   shape): ``BucketStoreServer`` over a third ``DeviceBucketStore`` (2^24
   slots, 2^20 counters, a ManualClock) on 127.0.0.1, limiters on
   ``RemoteBucketStore`` clients. ``acquire_many`` over 10,000,000 distinct
   keys as ``ACQUIRE_MANY`` frames resolved from the frames' bytes on the
   server (``wire.KeyBlob``), then 1M of them with remaining; from a client
   process of its own (``chip_smoke.py --scalar-client``), 10 rounds of
   ``acquire_async`` over 10,000 uniform keys with 64 tasks, alternating a
   coalescing client and one sending a frame per request (token limit 5:
   every round grants all, then denies all; each key grants exactly 5);
   cap-5 × 32 → 5 on both lanes; windows over the wire (1M keys as
   ``BULK_KIND_WINDOW`` frames, 4,000 ``OP_WINDOW`` / ``OP_FWINDOW``
   requests, cap-5 × 32 → 5), a raw ``OP_CONFIG`` fetch answering
   ``{"version": 0, "rules": []}`` and raw ``OP_RESERVE`` / ``OP_SETTLE``
   frames (a hold of 10 settled at 4); 4,000 ``OP_SEMA`` acquires (cap-5 × 32
   → 5 a round) and their releases; 4,000 ``OP_ACQUIRE_H`` requests on the
   LLM rows and the 2^16 rows as ``BULK_KIND_HBUCKET`` frames (one per
   tenant in each 2,048-row window), grants equal to the port's CPU store;
   eight approximate limiters syncing one counter over the wire; the
   periodic sweeper (0.5 s) evicting exactly every bucket, window, the
   counter and every idle semaphore a day later. Prints the wire rates,
   latencies (client and server), frames, and the server's key-blob
   resolve beside the in-process string resolve; then the path's launches
   by width, and fails if a scan held a single batch (every bulk frame of
   at most 4,096 rows is one flush of its rows).
11. The console entry point on the card: ``python -m
   distributedratelimiting.redis_tpu_torch.runtime.server --port 0 --slots
   1048576 --sweep-period 1`` as a subprocess: its listening line, ping,
   cap-5 × 32 → 5 for a bucket and for a window, ``OP_STATS`` keys,
   SIGTERM → exit 0.
12. The bench path: ``redis_tpu_torch/bench.py``'s headline, compact and
   single-batch sections at their full widths (10M slots, 32 x 8192, 16 x
   8192, B = 8192), five timed dispatches each; the launches must be the
   sections' dispatches exactly, and the table sane after them.
13. The native front-end and tier-0 (``--paths native``;
   ``runtime/native_frontend.py`` over ``native/frontend.cc``, built at first
   use): ``BucketStoreServer(native_frontend=True)`` over a card
   ``DeviceBucketStore`` of 2^24 slots. From a client process of its own
   (``chip_smoke.py --native-client``), 100,000 ``ACQUIRE`` frames from
   ``native_loadgen`` (4 connections; its keys, round-robin over a 1M
   keyspace) at depth 64 and 256, the server's C histogram p50/p99 beside
   each, and the same client against the port's asyncio listener over the
   same store at depth 64 (25,000 frames); cap-5 x 32 -> 5 through the native batch lane for
   buckets, sliding and fixed windows and semaphores; a seeded mixed
   sequence (ACQUIRE with probes, WINDOW, FWINDOW, SEMA acquire then release
   on one key, PEEK, HELLO, chained ACQUIRE_MANY chunks, a malformed frame)
   on a ManualClock, its replies byte for byte and the store's state equal to
   the asyncio server's over an equal card store, tier-0 off; tier-0 (a hot
   set of 4 keys of 20,000 tokens, 40,000 requests each, and a cold tail of
   40,000 keys): its hit rate,
   ``overadmit_max`` within ``overadmit_epsilon(headroom_budget(cap))`` and
   the hot grants equal to the device-only oracle's plus
   ``overadmit_total``, an unexhausted key's ``peek`` showing the reconciled
   debit, ``debit_packed`` launched; the 10M-key bulk as ``ACQUIRE_MANY``
   frames in calls of 1M keys (the C lane parks at most 64 MB of a
   connection's chained chunks), every row residue, decided by
   ``acquire_scan``, grants and
   remaining equal to the asyncio lane's over an equal store; shards 1 and
   4 under the bulk loadgen (rows/s, ``local_frac``); the io_uring probe
   and each shard's transport and fallback reason.
14. The device-resident fingerprint directory (``--paths fp``;
   ``runtime/fp_store.py`` over ``csrc/fp_directory.cu``). First (in the
   whole script right after phase 2, before any path, so that their
   ``torch.profiler`` sessions record device time) each fp
   entry point against its plain version on 2^24-slot tables holding 1M
   keys, compared BY KEY (each key looked up in both tables; which row wins
   a contested cell is the atomics' order on the card) and by the table's
   invariants (no key in two cells, every cell in its key's window), each
   launch with its cold and warm event ms, device ms and bound:
   ``fp_acquire_scan`` at K = 1 of 8, 64 and 4,096 rows (Zipf(1.2) and
   distinct keys, half of them new) and at the store's chunk of 8 x 4,096,
   and ``fp_window_scan`` sliding and fixed at K = 1 of 64 and 4,096 Zipf
   rows and at 8 x 4,096, distinct and Zipf, f32 and bits out (and all three
   at K = 1 of 4,096 Zipf rows, bits out), each decision's device ms split
   by kernel (``--fp-bench [JSON]`` runs these cases and the mesh's alone);
   under
   window pressure (8 x 4,096 new keys into 2^16 slots half full) every
   card row left unresolved has a full window, beside the plain version's
   (JAX's R rounds) count; ``fp_debit`` at 4,096 rows (repeats, refunds) and one
   valid row of 8; ``fp_peek`` at 4,096 (no cell claimed) and at one
   valid row of 8 (``peek_blocking``'s shape); both sweeps over 2^24 slots
   at a tick that expires about half the table; both migrates' table form
   (growth: one launch a pass) from a 2^22-slot table of 1M entries into
   2^23 slots against the plain version (JAX's passes in chunks of 4,096),
   every entry placed, by key and by the invariants, one launch timed
   beside the zeroing of the new table, then the chunked replay the growth
   loop ran before (a launch and a readback a chunk of 4,096), its wall
   seconds and launches. Then, counts reset, ``FingerprintBucketStore(n_slots=
   2^24)`` beside a host-directory ``DeviceBucketStore`` of 2^24 slots on
   one ManualClock: 10M distinct keys through ``acquire_many`` in calls of
   1M (the cold pass claims, the warm pass verdict-only), grants and
   remaining equal (the cold pass with no retry: a row may differ only
   where the fp store counted it unresolved, denied with remaining 0; those
   rows sent again once then equal), rows/s of both stores and the host hash's seconds beside
   the kernels' device ms a call; 10,000 sampled peeks and a 100,000-key
   debit with refunds equal; sliding and fixed windows over the 10M keys
   equal (as the cold pass); a snapshot round trip of the fp store (peeks equal); a day later
   ``sweep_all`` frees every slot and every cell, as many as the host
   store's; a 2^20-slot fp store fed 2M keys (buckets, then sliding
   windows; pressure-denied rows sent again) growing at least twice (each
   growth's wall seconds and the store lock's longest hold during it),
   peeks and next window grants equal to a host store's; no key through the
   Python hash (the native library loaded); the console server with
   ``--directory fp`` as in phase 11.
15. The key-sharded mesh store (``--paths mesh``; ``parallel/`` over
   ``csrc/mesh.cu``'s ``global_tier`` and the scans), BASELINE config 5 on
   one card. First (in the whole script right after the fp cases)
   ``global_tier`` against its plain version at K x R = 16 x 8,192 (the
   bulk chunk of 8 shards), 1 x 8, 1 x 8,192, 8 x 8,192, 32 x 4,096 and
   1 x 65,536, both cadences, fresh and live counters, equal bit for bit;
   ``fp_acquire_scan`` and ``fp_window_scan`` with 8 shard regions at 8 x
   4,096 rows on 2^24-slot tables, ``fp_peek`` and ``fp_migrate`` at 4,096,
   and ``fp_migrate``'s table form from a 2^22-slot table of 1M entries in 8
   regions into 2^23 slots (the plain version in the mesh tier's chunks of
   512 a region), by key and by the regions' invariants. Then, counts reset,
   ``MeshBucketStore`` over a mesh of 8 x ``cuda`` with 2^21 slots a shard,
   10M distinct keys through ``acquire_many`` in calls of 1M against a
   single-table ``DeviceBucketStore`` of 2^24 slots on the same keys and
   clock (JAX's differential anchor): two passes at ``sync_cadence="batch"``
   and one at ``"launch"``, grants and remaining equal, ``global_score``
   within 3 float32 roundings a recurrence of a float64 oracle; each
   cadence's device ms of a 1M-key call (decisions, ``global_tier``); the
   sliding and fixed window tiers at 10M keys equal; a snapshot of the
   10M-key store restored (state, counter and 10,000 peeks equal);
   ``directory="fp"`` cold (growth allowed and timed; unresolved rows sent
   again once) and warm, equal; a ``BucketStoreServer`` over an 8-shard store with a
   client process (``chip_smoke.py --mesh-client``): a 1M-key bulk and
   4,000 ``acquire_async``, ``OP_STATS``' tiers; the console server with
   ``--backend mesh --sync-cadence launch`` as in phase 11.
16. Placement and live migration (``--paths placement``;
   ``runtime/placement.py``, BASELINE config 2 made elastic): three
   ``BucketStoreServer``s, each over a card ``DeviceBucketStore`` of 2^24
   slots (the cut: three nodes share one card), on one frozen ManualClock
   (the handoff envelopes read it too). 1,000,000 bucket keys (cut from
   BASELINE's 10,000,000: the path alone took over 200 s at 10M, 101 s
   at 4M and 53-73 s at 2M, in a script that must end within 1,200 s and
   now runs the cluster path too), 100,000 sliding
   windows, 10,000 counters and 10,000 semaphores (2 permits held)
   loaded at epoch 0 under ``PlacementMap.initial(2)`` over nodes 0 and 1,
   each node's keys through ``acquire_many`` over the wire; 1,000 sampled
   keys answer on their owner and ``placement moved`` on the other. The
   join of node 2 (``rebalance_moves([0, 1, 2])``, epoch 1) by the
   script's coordinator (``_PlaceCoordinator``, JAX ``cluster.py:781-912``
   step for step: health, pull page by page, split and push in chunks,
   commit to the new owner first): the pull's seconds and the store
   lock's longest hold, the push's seconds and rows/s, the import's
   ``debit_packed`` launches and CUDA-event ms. 10,000 moved keys: 8 asks
   each at its old owner while that owner's export runs (its slots parked,
   its pull not yet answered), then inside the handoff window (node 2
   committed, the sources parked) 16 asks at both owners:
   admitted(old) + admitted(new) <= the pre-pull balance + one
   ``headroom_budget`` envelope, key by key; a settle there defers, a
   reserve serves from the envelope. After the commit: every moved key's
   balance on node 2 equals a host float32 oracle of ``debit_export``, its
   old owner holds the envelope and answers MOVED to node 2 (1,000 over
   the wire, peeks on node 2 equal), every unmoved balance unchanged;
   windows, counters and semaphores as the generic lane replays them; the
   hold exported with the pull settles on node 2 and answers MOVED on node
   0. A drain of node 1 aborted after its pull's first page and one push:
   the epoch kept, node 1 serving its residual, the push retried applied
   again.
   ``OP_STATS``' ``placement``, ``drl_placement_*``, a clean audit with
   envelope ε > 0. A native and an asyncio server over equal card stores,
   announced one map and parked on one slot: per-request and bulk frames
   on owned, moved and parked keys answer byte for byte alike; the
   asyncio one's ``OP_SAVE`` stamps the epoch and a load held to another
   raises ``PlacementMismatchError``.
17. Live config (``--paths config``; ``runtime/liveconfig.py``, the server's
   ``OP_CONFIG`` and gates, the client's chase): one ``BucketStoreServer``
   over a card ``DeviceBucketStore`` of 2^24 slots on a frozen ManualClock,
   the exact cell's deployment. 1,000,000 bucket keys (cut from
   BASELINE's 10,000,000: at 2,000,000 the whole script ran 1,130 s) at
   capacity 10 with seeded
   spends of 0-10, 100,000 sliding and 100,000 fixed windows with seeded
   counts, loaded over the wire; a fresh node's fetch reads version 0.
   Version 1 cuts the bucket capacity to 6: the commit's seconds, the store
   lock's longest hold (the snapshot), the rebase's ``debit_packed``
   launches and CUDA-event ms, ``rebased_rows`` 1,000,000; while it runs a
   client asks one unit a key a round on 10,000 keys at the old config
   until they deny: admitted <= the pre-commit balance + the one round in
   flight at the flip, key by key (the over-admission and the longest
   round, the serving stall, printed). Every bucket on the new config
   equals a host float32 oracle of the rebase (``max(0, 6 - spent)``)
   through the export, and 2,000 PEEKs at the old config over the wire;
   versions 2 and 3 (a sliding and a fixed window cut) replay to
   ``floor(min(count, limit))`` in window flushes; a hold reserved before
   the commit settles after it on the new table; 4 fresh clients take one
   moved error each, then translate; the moved text equals
   ``moved_message``; a revert (version 4) deletes the fixed window's
   self-rule; a stale prepare raises ``StaleConfigError`` over the wire. A
   native server with tier-0 over a card store of its own (JAX
   ``tests/test_upgrade.py:858``'s shape): the pump retires the replica
   (``retired_config_rows`` >= 1), the new table accounts for every grant,
   and its batch-lane and bulk-lane moved answers equal an asyncio server's
   byte for byte. ``OP_STATS``' ``config``, the ``drl_config_*`` families, a
   clean audit.
18. Drain-and-handoff shutdown (``--paths drain``; the server's
   ``shutdown``, the drain gates and the settle relay): a source and a
   successor ``BucketStoreServer``, each over a card ``DeviceBucketStore``
   of 2^24 slots on one frozen ManualClock, the exact cell's server
   restarted in a rolling way. The source holds 1,000,000 bucket keys (cut
   from 10,000,000, as the config cell's) at capacity 10 with seeded spends
   of 0-10, a quarter of them at a config version 1 retires (capacity 10 ->
   6), 100,000 sliding windows, 10,000 counters and semaphores and 300 open
   holds. ``shutdown(successor, window_s=2.0)``: the export's seconds and
   the store lock's longest hold, the source debit's ``debit_packed``
   launches and CUDA-event ms, the push's seconds and rows/s and the
   import's launches per kernel, the linger, the envelope decisions; a
   client asks one unit a key a round on 10,000 keys through the source
   while its gate is on (the longest round, the serving stall) and two holds
   settle through it (relayed), then asks through the successor until it
   denies. The successor's export equals a host float32 oracle of
   ``debit_export`` row for row (windows, counters, semaphores and the
   ledger too); admitted(source) + admitted(successor) <= the pre-drain
   balance + one envelope, key by key; ``shipped_rows`` equals the exported
   rows; the successor runs config version 1 and a fresh client at the old
   config chases one moved error. A drain whose successor closes after its
   first push falls back to the final checkpoint, which restores equal to
   the debited source; a source with no snapshot path raises, disarms its
   gate and drains on a retry.
19. The cluster and its controller (``--paths cluster``;
   ``runtime/cluster.py``, ``runtime/controller.py``, BASELINE config 2
   made a three-node fleet): three ``BucketStoreServer``s, each over a
   card ``DeviceBucketStore`` of 2^24 slots on one frozen ManualClock (the
   cut: the nodes share one card), behind one port ``ClusterBucketStore``
   with breakers on a manual clock, the degraded fallback and ``deny``
   partial failures. 1,000,000 bucket keys (cut from 10,000,000, as the
   config and drain cells) at capacity 10 spending 1-3 through
   ``acquire_many`` in 250,000-row calls, 250,000 unit window asks over
   100,000 sliding windows, 10,000 counters (``sync_counter``), 10,000
   semaphores (2 held), the LLM workload's 2^16 two-level rows and 300
   reserve/settle pairs: grants and remaining equal host oracles (float32
   balances, the window path's serial oracle, the plain versions on the
   host for the two-level rows), each tenant within its budget; the
   fan-out's rows/s beside one server's wire bulk. 10,000 routed
   ``acquire`` and 2,000 ``peek_blocking``, p50 and p99; each node's
   ``OP_STATS`` rows equal the keys ``node_index_of`` routes to it;
   ``cluster_metrics()``'s sums equal the node series. Node 1's server
   stops (its store kept): 8 rounds of unit asks on 10,000 of its keys
   open its breaker after 3 failures and serve from the degraded envelope
   (<= ``headroom_budget(10, 0.5)`` + its refill a key); nodes 0 and 2
   exact; a client without the fallback denies node 1's rows; a restart on
   the same port and one probe close the breaker (flight frames,
   ``drl_cluster_breaker_state``); the rejoin debit leaves each asked key
   at its pre-outage balance less its degraded grants. ``add_node`` of a
   fourth server: the pull's and the push's seconds, the store lock's
   longest hold, rows/s, the import's ``debit_packed`` launches; moved
   balances equal a host oracle of ``debit_export``, unmoved ones
   unchanged; a client at epoch 0 sends 1,000 moved keys, each chasing one
   MOVED to node 3. A ``Controller`` ticked by hand over Zipf(1.1) traffic
   on 100,000 keys splits the hot key (its balance on the new owner equal
   to the oracle), arms the retry-shed and doomed-work gates on every
   server after two ticks of retried reserves and releases them after
   three calm ticks; a dry-run twin fed the same ``Sensors`` decides the
   same intents; node 0's ``/metrics`` carries ``drl_controller_*`` and its
   incident bundle the controller's actions. Two days on, ``sweep_all``
   evicts exactly every node's expired slots.
20. Global quota federation (``--paths federation``;
   ``runtime/federation.py``, the server's ``OP_FED_*``, the client's
   ``fed_lease`` / ``fed_renew`` / ``fed_reclaim``; JAX's 3-region soak,
   ``tests/test_federation.py:596-900``, on the card): first one slice
   commit on a card store of 2^24 slots a table (one tenant key), timed.
   Then a home ``BucketStoreServer`` over a card ``DeviceBucketStore`` with
   ``federation_ledger(default_ttl_s=6.0)`` and a ``SnapshotChain``; regions
   r0 and r2 single servers over card stores (slices apply through
   ``config_announce``), r1 a two-server ``ClusterBucketStore`` (through
   ``mutate_config``); every store on one frozen ManualClock, its tables
   2^12 slots to start (a card store keeps one table per config, and every
   tenant budget, slice and envelope is one: 2^24 a table would put 37 GB
   on the home alone). 64 global tenants (cut from 256: a slice commit
   snapshots every table of its region; ``FED_TENANTS=N`` sets another
   count), cap 60 + i and rate (100 + i) x 1e-4, so that the slices, r2's
   envelope and the global bound deny asks, as JAX's 600-token soak
   budget does under the same ask counts. 26 rounds on manual
   monotonic lease clocks, a second a round, TTL 6 s, renew fraction 0.5:
   each region's agent ticks (lease, renew, degrade), then 0-4 seeded unit
   asks a region and tenant go out at once under the first slice's
   operands (later slices are chased). r0 heats up at round 4; the soak's
   chaos on the federation seams; r2 fully partitioned from round 8 to 20;
   the home crashes at round 14 and restarts from its chain (the load's
   seconds; ``restores`` 1, no lease's term longer, a WAN retry of every
   r0 lease answers duplicate). A ``Controller`` with ``federation=`` r0's
   agent, ticked by hand 6 times: the actuator at every third tick (and
   on the degraded rung), a dry-run twin deciding the same intents. The
   stall: r0 loaded with 1,000,000 bucket keys, one tenant's resize forced
   through a renew: the commit's seconds, the store lock's longest hold,
   the longest ask round of another tenant meanwhile. Every region
   reclaims. Checks: no slice application raised, and every lease not
   degraded serves its slice; every home reply equal to a host replay (a
   port ``FederationLedger`` over an ``InProcessBucketStore`` fed the same
   requests at the same clock readings; ids, epochs and flags exact,
   tokens within 1e-6 relative), and the home card store's global buckets
   equal to the replay store's, each tenant's spend plus debt equal to
   its admits (one float32 spacing of the cap a debit); every grant and
   every tenant balance in every table equal to a float32 oracle of the
   region's applied config history; some asks denied, in r2's partition
   too; Σ admits a tenant <= cap + rate x elapsed + ε; r2's partition
   admits <= 2 x its envelope; the heal re-leases r2 with fresh ids,
   ``refunded_tokens`` > 0; the home's audit with no federation breach;
   ``drl_federation_*``, ``drl_federation_slice_share`` and (r0)
   ``drl_federation_region_*`` on ``/metrics``; ``sweep_all`` two days on
   evicts exactly every store's slots. Prints renews/s one at a time and
   their p50 / p99, the slice commits' count, p50 and max, and the
   launches of ``debit_packed`` and the flushes.
21. Print ``{"kernels": [...]}``: per kernel (25) its launches on each path
   of phases 3–10 and 12–20 (``launches_by_path``; counts set to 0 before each
   path and read after it; > 0 on the path the kernel serves, the
   two-level kernel and the debit > 0 on the reservation path, every
   store kernel but the window flushes > 0 on the checkpoint path, the
   bucket flushes, the bucket scan, the two-level kernel and the debit > 0
   on the observability path, the batch lane's flushes, the bulk scan and
   the debit > 0 on the native path, every fp kernel > 0 on the fp path,
   ``global_tier``, the two scans and the fp decision > 0 on the mesh path,
   the debit, the window, counter and semaphore flushes, the bucket flush
   and the bucket scan > 0 on the placement path, the debit, the window
   flush, the bucket flush and the bucket scan > 0 on the config path, the
   debit, the window, counter and semaphore flushes, the bucket scan and
   the two-level kernel > 0 on the drain path, the bucket and window scans
   and flushes, the counter, semaphore and two-level kernels, the debit and
   the bucket sweep > 0 on the cluster path (its windows by the grouped and
   the plain flush), the debit and a bucket flush (``acquire_packed`` or
   ``acquire_grouped``) > 0 on the federation path, and every kernel that a
   wire
   op reaches > 0 on the server path — all but
   the bench's ``acquire_scan24`` and ``acquire_batch``, the fp kernels,
   whose store the fp path serves, and ``global_tier``, whose the mesh path
   serves) and their sum
   (``launches``), the flushes',
   counter syncs' and debits' launches on those paths by operand width
   (``launch_sizes``), the error against the plain version, and its times;
   before it, each phase's wall seconds.
22. Last line: ``{"ok": true, "device": {...}}``.

Phases 3-10 and 12-20 run in this order in one process, but for the side
lanes: after the exact path, while this process runs the placement,
config and federation paths, three processes of their own (``python3
chip_smoke.py --lane NAME,...``, started and stopped by this one) run the
cluster and reservation paths, the checkpoint, approximate, window and
admission paths, and the fp and mesh paths on the same card; the server,
bench, native, observability and drain paths then run alone. Each path's
launch counts are set to 0 just before it and read just after it, in the
process that runs it.

It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import gc
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 1234
N_SLOTS = 2**24
BATCH = 4096
N_KEYS = 10_000_000
SCAN_K = 32  # batches in one bulk chunk (the store's largest K)
COUNTER_SLOTS = 2**20
N_COUNTER_KEYS = 1_000_000
COUNTER_ROUNDS = 16
ROUND_DRAWS = 2**18
ZIPF_S = 1.1
DECAY_PER_S = 10.0  # the counters' decay rate (per second)
ATOL = 1e-4
#: H100 SXM device-memory rate and float32 rate outside the tensor cores
#: (NVIDIA data sheet, at the 700 W limit), for the bound.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 30
#: The server path's scalar phase (BASELINE config 2's shape): 100,000
#: requests since the window path joined the script (200,000 before).
N_SCALAR_KEYS = 10_000
SCALAR_LIMIT = 5
SCALAR_ASKS = 10
#: The window path (BASELINE config 4): a sliding window of 100 permits a
#: second over the 10M keys, bursty Poisson arrivals on a ManualClock.
WINDOW_LIMIT = 100
WINDOW_TICKS = 1024  # one second
WINDOW_STEPS = 40
WINDOW_STEP_TICKS = 48  # ~47 ms of store time a step
WINDOW_BASE_ARRIVALS = 400  # Poisson mean a step; 10x in a burst step
WINDOW_BURST_SHARE = 0.25
N_HOT = 64
HOT_SHARE = 0.5  # of a burst step's arrivals
#: The server path's window traffic.
N_WIRE_WINDOW_KEYS = 1_000_000
N_WIRE_SCALAR_WINDOW_KEYS = 200
WIRE_WINDOW_LIMIT = 6
WIRE_WINDOW_ASKS = 10
SCALAR_TASKS = 64
SCALAR_LANES = ("coalesced", "per-request")
#: The admission path. Semaphores: a 2^20-slot table (BASELINE config 3's
#: counter size, 9 B a slot), 1M keys. Two-level admission: the LLM workload
#: of benchmarks/llm_workload.py:63-91 at the device size of
#: benchmarks/recapture.py:143-170 (its seed 9, 2^16 rows, 2^18 slots,
#: max_batch 4096), key budget 1e6 and tenant budget 5e6 tokens, both at
#: 1e5 tokens/s; the binding arm lowers the tenant budget to 5e4 tokens and
#: advances the clock 10 ticks before each 2,048-row window.
SEMA_SLOTS = 2**20
N_SEMA_KEYS = 1_000_000
LLM_SEED = 9
LLM_ROWS = 2**16
LLM_SLOTS = 2**18
LLM_BUDGETS = (1e6, 5e6)  # (key, tenant) tokens
LLM_RATE = 1e5  # tokens/s at both levels
LLM_BINDING_TENANT = 5e4
LLM_WINDOW = 2048
LLM_STEP_TICKS = 10
LLM_POLICY_ROWS = 2048
#: Tier-0 debit on the exact path's table: every tenth of its keys.
N_DEBIT_STRIDE = 10
#: The server path's semaphore and two-level requests.
N_WIRE_SEMA_ROUNDS = 125  # x 32 acquires on a cap-5 key
N_WIRE_HIER = 4000


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _median_ms(fn, setup=None, reps=REPS, warmup=3, inner=1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call."""
    import torch

    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms(fn, kernel_names, reps=20, setup=None):
    """Device time per call of the named CUDA kernels, summed from a
    ``torch.profiler`` trace of ``reps`` calls (each after ``setup``, whose
    kernels are not named); ``None`` if the trace holds no device time for
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if any(k in e.key for k in kernel_names))
    return us / 1e3 / reps if us > 0 else None


def _time_calls(obj, name: str, acc: list) -> None:
    """Wrap the method ``obj.name`` so that its wall time accrues to
    ``acc[0]``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t

    setattr(obj, name, timed)


class _GcClock:
    """Wall time spent in Python's cyclic garbage collector, and its passes
    by generation (a ``gc.callbacks`` entry)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.longest = 0.0  # the longest single collection
        self.passes = [0, 0, 0]
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            pause = time.perf_counter() - self._start
            self.total += pause
            self.longest = max(self.longest, pause)
            self.passes[info["generation"]] += 1


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 (non-tensor-core) rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() \
        else 0.0


def _check_equal(what, got, want) -> None:
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{what}: {bad} elements differ")


def _check_close(what, got, want) -> float:
    err = _max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"{what}: max abs error {err} > {ATOL}")
    return err


def _check_repeated_adds(what, slots, got, want) -> tuple[float, float]:
    """Counter values after a sync whose slots repeat, each slot against its
    own limit. The plain version on the card sets every touched slot to its
    decayed value, then adds slot s's r_s counts in an order its atomics
    choose; the kernel rounds their exact sum once. Decayed values and
    counts are >= 0 here, so every partial sum lies within the final one and
    each rounding is at most half a spacing of max(|got_s|, |want_s|): the
    two differ by at most r_s such spacings. A slot with one add or none
    must be equal. ``slots`` indexes ``got`` and ``want`` (out-of-range rows
    dropped). Returns the largest error and the limit of that slot."""
    n = len(got)
    slots = slots[(slots >= 0) & (slots < n)]
    reps = np.bincount(slots, minlength=n)
    got64, want64 = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag).astype(np.float64)
    err = np.abs(got64 - want64)
    bad = np.flatnonzero(err > tol)
    if len(bad):
        s = bad[np.argmax(err[bad] - tol[bad])]
        raise AssertionError(
            f"{what}: {len(bad)} slots past their limit, e.g. slot {s} "
            f"({reps[s]} adds): {got[s]} vs {want[s]}, limit {tol[s]}")
    worst = int(np.argmax(err))
    return float(err[worst]), float(tol[worst])


def kernel_phase(torch, K, ck, dev):
    """Each kernel against its plain version on the card; returns per-kernel
    results (error, times, bound)."""
    rng = np.random.default_rng(SEED)
    cap, rate = 100.0, 10 / 1024
    res = {}

    # -- sweep_expired at N = 2^24 -------------------------------------------
    n = N_SLOTS
    now = 2_000_000
    tokens = torch.tensor(rng.uniform(0, cap, n).astype(np.float32), device=dev)
    last_ts = torch.tensor(rng.integers(now - 30_000, now, n).astype(np.int32),
                           device=dev)
    exists0 = torch.tensor(rng.random(n) < 0.5, device=dev)
    state = K.BucketState(tokens, last_ts, exists0.clone())
    mask, counts = ck.sweep_expired(state, now, cap, rate)
    plain = K.BucketState(tokens, last_ts, exists0.clone())
    _, expired = K.sweep_expired(plain, now, cap, rate)
    torch.cuda.synchronize()
    _check_equal("sweep mask", mask.bool(), expired)
    _check_equal("sweep exists", state.exists, plain.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(-1, ck.TILE
                                                               ).sum(1)
    _check_equal("sweep tile counts", counts, want_tiles.int())
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep case expired {n_expired}: not a mix")
    ms = _median_ms(lambda: ck.sweep_expired(state, now, cap, rate),
                    setup=lambda: state.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_expired(plain, now, cap, rate),
                          setup=lambda: plain.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_expired(state, now, cap, rate),
                        ["sweep_kernel"])
    t = counts.numel()
    # ~12 operations a slot: the TTL (sub, max, max, div, ceil, max, min,
    # select), the elapsed time (sub, max) and the test (compare, and).
    res["sweep_expired"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=9 * n + 2 * n + 4 * t, ops=12 * n, device_ms=dev_ms)
    print(f"sweep_expired N={n}: expired {n_expired}, equal to plain; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} ms)")

    # TTL saturation: with rate 0 or 1e-9 the float32 TTL clamp is 2^31 and
    # must convert to 2^31 - 1, so nothing idle for 2^30 ticks expires.
    m = min(2**20, n)
    # Deficits of 10+ tokens: at rate 1e-9 the TTL passes 2^31 ticks.
    sat = K.BucketState(tokens[:m] * 0.9, torch.zeros(m, dtype=torch.int32,
                                                        device=dev),
                        torch.ones(m, dtype=torch.bool, device=dev))
    for r in (0.0, 1e-9):
        sat_mask, sat_counts = ck.sweep_expired(sat, 2**30, cap, r)
        ref = K.BucketState(sat.tokens, sat.last_ts,
                            torch.ones(m, dtype=torch.bool, device=dev))
        _, ref_expired = K.sweep_expired(ref, 2**30, cap, r)
        _check_equal(f"saturation mask rate={r}", sat_mask.bool(),
                     ref_expired)
        if int(sat_counts.sum()) != 0 or not bool(sat.exists.all()):
            raise AssertionError(f"TTL saturation: slots expired at {r}")
    print("sweep_expired TTL saturation (rate 0, 1e-9): nothing expired, "
          "equal to plain")

    # -- acquire_packed / acquire_grouped at B = 4096 -------------------------
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
    )

    table = (torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                          device=dev),
             torch.tensor(rng.random(n) < 0.7, device=dev))
    slots = (rng.zipf(1.2, BATCH) - 1) % n
    slots[rng.random(BATCH) < 0.02] = -1
    slots = slots.astype(np.int32)
    cnt = rng.integers(0, 40, BATCH).astype(np.int32)
    valid = slots >= 0
    packed = np.zeros((4, BATCH), np.int32)
    packed[0], packed[1], packed[2] = slots, cnt, now
    packed[3][valid] = _duplicate_prefix_host(slots[valid], cnt[valid])
    uniq, sizes = np.unique(slots[valid], return_counts=True)
    g = len(uniq)
    packed5 = np.full((5, BATCH), -1, np.int32)
    packed5[1:] = 0
    packed5[0, :g], packed5[2] = uniq, now
    packed5[1, :g] = rng.integers(1, 4, g)
    packed5[4, :g] = sizes
    d_uniq = g  # distinct valid slots gathered and written back
    # Bytes: the operand read, out written, 9 B gathered and 9 B written
    # back per distinct slot. Operations: ~15 a row (refill, prefix test,
    # remaining, the consumption add); the grouped division and clamps ~18.
    cases = {
        "acquire_packed": (ck.acquire_packed, K.acquire_batch_packed, packed,
                           16 * BATCH + 8 * BATCH + 18 * d_uniq, 15 * BATCH),
        "acquire_grouped": (ck.acquire_grouped,
                            K.acquire_batch_packed_grouped, packed5,
                            20 * BATCH + 8 * BATCH + 18 * d_uniq, 18 * BATCH),
    }
    for name, (kernel, plain_fn, op, nbytes, ops) in cases.items():
        op_d = torch.from_numpy(op).to(dev)
        ks = K.BucketState(*(x.clone() for x in table))
        ps = K.BucketState(*(x.clone() for x in table))
        out = kernel(ks, op_d, cap, rate)
        _, pout = plain_fn(ps, op_d, cap, rate)
        torch.cuda.synchronize()
        # One writer a slot: results and every state field exact.
        _check_equal(f"{name} out", out, pout)
        for field in ks._fields:
            _check_equal(f"{name} {field}", getattr(ks, field),
                         getattr(ps, field))
        err = 0.0
        granted = float(out[0].sum())
        if not 0 < granted:
            raise AssertionError(f"{name}: nothing granted")
        ms = _median_ms(lambda: kernel(ks, op_d, cap, rate), inner=20)
        plain_ms = _median_ms(lambda: plain_fn(ps, op_d, cap, rate))
        dev_ms = _device_ms(lambda: kernel(ks, op_d, cap, rate),
                            FLUSH_KERNELS)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bytes=nbytes, ops=ops,
                         device_ms=dev_ms)
        print(f"{name} B={BATCH} ({d_uniq} distinct slots): out and every "
              f"state field equal to plain; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, device time {dev_ms} ms)")
    res["acquire_scan"] = scan_case(torch, K, ck, dev, rng, table, now, cap,
                                    rate)
    del table, tokens, last_ts, exists0, state, plain, sat
    torch.cuda.empty_cache()
    res.update(counter_cases(torch, K, ck, dev, rng))
    torch.cuda.empty_cache()
    res.update(window_cases(torch, K, ck, dev, rng))
    torch.cuda.empty_cache()
    # Both scans at the shapes the chunks above do not cover; their rows
    # ride on the two scans' entries of the kernels line.
    for (name, shape), row in scan_shapes(
            torch, K, ck, dev, shapes=SCAN_SHAPES_ADDED).items():
        res[name].setdefault("shapes", {})[shape] = row
    torch.cuda.empty_cache()
    # The flushes at the shapes the store launches; their rows ride on the
    # four flush kernels' entries of the kernels line.
    for row in flush_shapes(torch, K, ck, dev):
        res[row["kernel"]].setdefault("shapes", {})[row["shape"]] = row
    torch.cuda.empty_cache()
    res.update(admission_cases(torch, K, ck, dev, rng))
    torch.cuda.empty_cache()
    bench_res = bench_cases(torch, K, ck, dev, rng)
    res["acquire_scan"].setdefault("shapes", {}).update(
        bench_res.pop("compact_shapes"))
    res.update(bench_res)
    return res


def _check_windows(what, ks, ps) -> None:
    """Every field of two window tables equal, bit for bit: counts are whole
    numbers, so even the flushes' atomic adds of duplicates sum exactly."""
    for name in ks._fields:
        _check_equal(f"{what} {name}", getattr(ks, name), getattr(ps, name))


def window_cases(torch, K, ck, dev, rng) -> dict:
    """The four window kernels against their plain versions on a window
    table of 2^24 slots (whole-number counts; indices current, one and two
    windows behind, and one ahead of a clock behind them): a flush of B =
    4096 with Zipf(1.2) duplicates, its grouped form, one bulk chunk of K =
    32 x 4096 (distinct and Zipf slots, the fused and the i32 lane, sliding
    and fixed; the ticks cross a window boundary), and the sweep. Grants,
    bits, masks, remaining and every state field must be equal."""
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
    )

    n, wt, limit = N_SLOTS, WINDOW_TICKS, float(WINDOW_LIMIT)
    now = 2_000_000 + 300
    idx = (now // wt + rng.choice([-2, -1, 0, 0, 1], n)).astype(np.int32)
    table = (torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                          device=dev),
             torch.tensor(idx, device=dev),
             torch.tensor(rng.random(n) < 0.7, device=dev))
    res = {}

    # -- window_packed / window_grouped at B = 4096 ---------------------------
    slots = ((rng.zipf(1.2, BATCH) - 1) % n).astype(np.int32)
    slots[rng.random(BATCH) < 0.02] = -1
    cnt = rng.integers(0, 40, BATCH).astype(np.int32)
    valid = slots >= 0
    packed = np.zeros((4, BATCH), np.int32)
    packed[0], packed[1], packed[2] = slots, cnt, now
    packed[3][valid] = _duplicate_prefix_host(slots[valid], cnt[valid])
    uniq, sizes = np.unique(slots[valid], return_counts=True)
    g = len(uniq)
    packed5 = np.full((5, BATCH), -1, np.int32)
    packed5[1:] = 0
    packed5[0, :g], packed5[2] = uniq, now
    packed5[1, :g] = rng.integers(1, 4, g)
    packed5[4, :g] = sizes
    # Bytes: the operand read, out written, 13 B gathered and 13 B written
    # back per distinct slot. Operations: ~30 a row (the advance, the
    # estimate's division and clamps, the test, remaining, the add).
    cases = {
        "window_packed": (ck.window_packed, K.window_acquire_batch_packed,
                          packed, 16 * BATCH + 8 * BATCH + 26 * g),
        "window_grouped": (ck.window_grouped,
                           K.window_acquire_batch_packed_grouped, packed5,
                           20 * BATCH + 8 * BATCH + 26 * g),
    }
    for name, (kernel, plain_fn, op, nbytes) in cases.items():
        op_d = torch.from_numpy(op).to(dev)
        for interpolate in (False, True):  # the sliding case is timed
            ks = K.WindowState(*(x.clone() for x in table))
            ps = K.WindowState(*(x.clone() for x in table))
            out = kernel(ks, op_d, limit, wt, interpolate=interpolate)
            _, pout = plain_fn(ps, op_d, limit, wt, interpolate=interpolate)
            torch.cuda.synchronize()
            kind = "sliding" if interpolate else "fixed"
            _check_equal(f"{name} ({kind}) out", out, pout)
            _check_windows(f"{name} ({kind})", ks, ps)
            # Requests asked: valid rows, or the members of the groups.
            asked = (int(op[4][op[0] >= 0].sum()) if len(op) == 5
                     else int(valid.sum()))
            if not 0 < float(out[0].sum()) < asked:
                raise AssertionError(f"{name} ({kind}): no mix of grants")
        ms = _median_ms(lambda: kernel(ks, op_d, limit, wt), inner=20)
        plain_ms = _median_ms(lambda: plain_fn(ps, op_d, limit, wt))
        dev_ms = _device_ms(lambda: kernel(ks, op_d, limit, wt),
                            FLUSH_KERNELS)
        res[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bytes=nbytes, ops=30 * BATCH,
                         device_ms=dev_ms)
        print(f"{name} B={BATCH} ({g} distinct slots), sliding and fixed: "
              f"out and every state field equal to plain; {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, device time {dev_ms} ms)")

    # -- window_scan: one chunk of K = 32 x 4096 ------------------------------
    k, b = SCAN_K, BATCH
    zipf = ((rng.zipf(1.2, (k, b)) - 1) % n).astype(np.int32)
    distinct = np.stack([rng.choice(n, b, replace=False)
                         for _ in range(k)]).astype(np.int32)
    for sl in (zipf, distinct):
        sl[rng.random((k, b)) < 0.02] = -1
    # Three ticks, the last in the next window.
    nows = np.repeat(np.array([now, now + 500, now + 900], np.int32),
                     [11, 11, k - 22])
    nows_d = torch.from_numpy(nows).to(dev)
    c8 = rng.integers(0, 40, (k, b)).astype(np.uint8)
    c32 = rng.integers(0, 1001, (k, b)).astype(np.int32)
    variants = {}
    for label, sl in (("distinct", distinct), ("Zipf", zipf)):
        variants[f"fused, bits, {label}"] = (sl, K.pack_compact5(sl, c8), c8,
                                             False)
        variants[f"fused, f32, {label}"] = (sl, K.pack_compact5(sl, c8), c8,
                                            True)
        variants[f"i32, f32, {label}"] = (sl, np.stack([sl, c32]), c32,
                                          True)
    out_res = {}
    for label, (sl, op, counts, with_rem) in variants.items():
        d = len(np.unique(sl[sl >= 0]))
        op_d = torch.from_numpy(op).to(dev)
        lim = limit if counts.dtype == np.uint8 else 500.0
        for interpolate in (True, False):
            kind = "sliding" if interpolate else "fixed"
            ks = K.WindowState(*(x.clone() for x in table))
            ps = K.WindowState(*(x.clone() for x in table))
            got = ck.window_scan_packed(ks, op_d, nows_d, lim, wt,
                                        interpolate=interpolate,
                                        with_remaining=with_rem)
            want = _plain_window_scan(torch, K, ps, sl, counts, nows_d, lim,
                                      wt, interpolate, with_rem)
            torch.cuda.synchronize()
            _check_equal(f"window_scan ({label}, {kind}) out", got, want)
            _check_windows(f"window_scan ({label}, {kind})", ks, ps)
            grants = (want[:, 0] > 0.5 if with_rem else torch.from_numpy(
                np.unpackbits(want.cpu().numpy(), axis=-1,
                              bitorder="little")))
            if not 0 < int(grants.sum()) < int((sl >= 0).sum()):
                raise AssertionError(f"window_scan ({label}, {kind}): no mix")
        call = (lambda ks=ks, op_d=op_d, with_rem=with_rem, lim=lim:
                ck.window_scan_packed(ks, op_d, nows_d, lim, wt,
                                      with_remaining=with_rem))
        ms = _median_ms(call, inner=5)
        slots_d = torch.from_numpy(sl).to(dev)
        counts_d = torch.from_numpy(counts.astype(np.int32)).to(dev)
        plain_ms = _median_ms(
            lambda ps=ps, slots_d=slots_d, counts_d=counts_d, lim=lim:
            K.window_acquire_scan(ps, slots_d, counts_d, slots_d >= 0,
                                  nows_d, lim, wt), reps=3, warmup=1)
        dev_ms = _device_ms(call, ["scan_kernel"])
        out_bytes = k * b // 8 if not with_rem else k * 2 * b * 4
        out_res[label] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=op.nbytes + 4 * k + out_bytes + 26 * d, ops=30 * k * b,
            device_ms=dev_ms)
        print(f"window_scan ({label}) K={k} B={b} ({d} distinct slots), "
              f"sliding and fixed: equal to plain; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, device time {dev_ms} ms)")
    # The window path's bulk sends distinct keys, verdicts only.
    res["window_scan"] = dict(out_res["fused, bits, distinct"])

    # -- sweep_windows at N = 2^24 -------------------------------------------
    exists0 = table[3]
    ks = K.WindowState(table[0], table[1], table[2], exists0.clone())
    ps = K.WindowState(table[0], table[1], table[2], exists0.clone())
    sweep_now = now + wt  # the "two behind" slots and the current-1 expire
    mask, counts = ck.sweep_windows(ks, sweep_now, wt)
    _, expired = K.sweep_windows(ps, sweep_now, wt)
    torch.cuda.synchronize()
    _check_equal("sweep_windows mask", mask.bool(), expired)
    _check_equal("sweep_windows exists", ks.exists, ps.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(
            -1, ck.TILE).sum(1)
    _check_equal("sweep_windows tile counts", counts, want_tiles.int())
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep_windows expired {n_expired}: no mix")
    ms = _median_ms(lambda: ck.sweep_windows(ks, sweep_now, wt),
                    setup=lambda: ks.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_windows(ps, sweep_now, wt),
                          setup=lambda: ps.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_windows(ks, sweep_now, wt),
                        ["sweep_windows_kernel"])
    # 7 B a slot (window_idx and exists read, exists and mask written) and
    # the tile counts; ~4 operations a slot (sub, compare, and, clear).
    res["sweep_windows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=7 * n + 4 * counts.numel(), ops=4 * n, device_ms=dev_ms)
    print(f"sweep_windows N={n}: expired {n_expired}, equal to plain; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} ms)")
    return res


def _plain_window_scan(torch, K, ps, slots, counts, nows_d, limit, wt,
                       interpolate, with_remaining):
    """The plain per-batch loop of the window scan on the card's tensors,
    in the result form of the kernel."""
    dev = nows_d.device
    slots_d = torch.from_numpy(slots).to(dev)
    _, granted, remaining = K.window_acquire_scan(
        ps, slots_d, torch.from_numpy(counts.astype(np.int32)).to(dev),
        slots_d >= 0, nows_d, limit, wt, interpolate=interpolate)
    if not with_remaining:
        return K.pack_grant_bits(granted)
    return torch.stack([granted.to(torch.float32), remaining], dim=1)


#: The bulk-lane scan shapes of :func:`scan_shapes`: a chunk of slots
#: distinct within each batch (a few repeat across batches), the main path's
#: chunk of keys distinct in the whole chunk, the Zipf(1.2) chunk in its
#: three operand forms, one slot taking every row of a chunk, one set of
#: 4,096 slots repeated in every batch at a tick of its own, and the
#: coalescing lane's K = 1 launch of a 4096-row operand with three valid
#: rows, and with a Zipf(1.2) batch.
SCAN_SHAPES = ("distinct (fused, bits)", "chunk-distinct (fused, bits)",
               "Zipf (fused, bits)",
               "Zipf (fused, f32)", "Zipf (i32, f32)", "hot slot (fused, bits)",
               "cross-batch repeats (fused, f32)", "K=1 padding (fused, f32)",
               "K=1 Zipf (fused, f32)")
#: The shapes the full run adds to ``scan_case`` and ``window_cases``.
SCAN_SHAPES_ADDED = ("chunk-distinct (fused, bits)", "hot slot (fused, bits)",
                     "cross-batch repeats (fused, f32)",
                     "K=1 padding (fused, f32)")


def _scan_shape(K, rng, shape: str, n: int, now: int):
    """One scan shape's inputs: ``(slots i32[K, B], counts, operand, nows
    i32[K], with_remaining)``; counts u8 for the fused operand, i32 up to
    1000 for the i32 one; 2% padding where the shape has any."""
    k, b = SCAN_K, BATCH
    if shape.startswith("K=1 Zipf"):
        k = 1
        slots = ((rng.zipf(1.2, (1, b)) - 1) % n).astype(np.int32)
    elif shape.startswith("K=1"):
        k = 1
        slots = np.full((1, b), -1, np.int32)
        slots[0, :3] = rng.choice(n, 3, replace=False)
    elif shape.startswith("chunk-distinct"):
        slots = rng.choice(n, k * b, replace=False).astype(
            np.int32).reshape(k, b)
    elif shape.startswith("distinct"):
        slots = np.stack([rng.choice(n, b, replace=False)
                          for _ in range(k)]).astype(np.int32)
    elif shape.startswith("Zipf"):
        slots = ((rng.zipf(1.2, (k, b)) - 1) % n).astype(np.int32)
    elif shape.startswith("hot slot"):
        slots = np.full((k, b), int(rng.integers(0, n)), np.int32)
    else:  # cross-batch repeats: the same slots, permuted, in every batch
        base = rng.choice(n, b, replace=False).astype(np.int32)
        slots = np.stack([rng.permutation(base) for _ in range(k)])
    if shape.startswith(("distinct", "chunk-distinct", "Zipf", "cross")):
        slots[rng.random((k, b)) < 0.02] = -1
    if shape.startswith("cross"):  # a tick of its own in every batch, one
        nows = (now + 37 * np.arange(k)).astype(np.int32)  # going back
        nows[k // 2] = nows[k // 2 - 1] - 100
    else:
        nows = np.repeat(np.array([now, now + 500, now + 900], np.int32),
                         [11, 11, k - 22]) if k == SCAN_K else \
            np.array([now], np.int32)
    fused = "i32" not in shape
    if fused:
        counts = rng.integers(0, 40, (k, b)).astype(np.uint8)
        op = K.pack_compact5(slots, counts)
    else:
        counts = rng.integers(0, 1001, (k, b)).astype(np.int32)
        op = np.stack([slots, counts])
    return slots, counts, op, nows, "f32" in shape


def scan_shapes(torch, K, ck, dev, shapes=SCAN_SHAPES) -> dict:
    """Both bulk-lane scans (``acquire_scan`` on a bucket table, and
    ``window_scan`` on a window table, sliding and fixed) at each shape of
    :data:`SCAN_SHAPES`, on 2^24-slot tables, against the plain per-batch
    loop: grants, bits, ``last_ts``/``window_idx``, ``exists`` and every
    window field equal; tokens and remaining within atol 1e-4. Prints and
    returns, per scan and shape, the CUDA-event ms, the profiler's device
    ms and the bound (the operand, ``nows`` and the result moved once, and
    18 B (buckets) or 26 B (windows) per distinct slot of this chunk)."""
    rng = np.random.default_rng(SEED + 7)
    n = N_SLOTS
    now = 2_000_000 + 300
    cap, rate = 100.0, 10 / 1024
    wt, limit = WINDOW_TICKS, float(WINDOW_LIMIT)
    idx = (now // wt + rng.choice([-2, -1, 0, 0, 1], n)).astype(np.int32)
    buckets = (torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                            device=dev),
               torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                            device=dev),
               torch.tensor(rng.random(n) < 0.7, device=dev))
    windows = (torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                            device=dev),
               torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                            device=dev),
               torch.tensor(idx, device=dev),
               torch.tensor(rng.random(n) < 0.7, device=dev))
    res = {}
    for shape in shapes:
        slots, counts, op, nows, with_rem = _scan_shape(K, rng, shape, n, now)
        k, b = slots.shape
        valid = slots >= 0
        d = len(np.unique(slots[valid]))
        op_d = torch.from_numpy(op).to(dev)
        nows_d = torch.from_numpy(nows).to(dev)
        slots_d = torch.from_numpy(slots).to(dev)
        counts_d = torch.from_numpy(counts.astype(np.int32)).to(dev)
        out_bytes = k * 2 * b * 4 if with_rem else k * b // 8
        # -- acquire_scan ----------------------------------------------------
        ks = K.BucketState(*(x.clone() for x in buckets))
        ps = K.BucketState(*(x.clone() for x in buckets))
        got = ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                     with_remaining=with_rem)
        _, pout = K.acquire_scan_packed(ps, slots_d, counts_d, nows_d, cap,
                                        rate)
        torch.cuda.synchronize()
        what = f"acquire_scan {shape}"
        err = _check_close(f"{what} tokens", ks.tokens, ps.tokens)
        _check_equal(f"{what} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"{what} exists", ks.exists, ps.exists)
        if with_rem:
            _check_equal(f"{what} grants", got[:, 0], pout[:, 0])
            err = max(err, _check_close(f"{what} remaining", got[:, 1],
                                        pout[:, 1]))
        else:
            _check_equal(f"{what} bits", got,
                         K.pack_grant_bits(pout[:, 0] > 0.5))
        granted = int((pout[:, 0] > 0.5).sum())
        if not 0 < granted <= int(valid.sum()):
            raise AssertionError(f"{what}: granted {granted}")
        call = (lambda: ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                               with_remaining=with_rem))
        row = _scan_row(call, op.nbytes + 4 * k + out_bytes + 18 * d,
                        15 * k * b, err)
        res[("acquire_scan", shape)] = row
        print(f"acquire_scan {shape} K={k} B={b} ({d} distinct slots, "
              f"{granted} granted): equal to plain; {row['ms']:.4f} ms, "
              f"device {row['device_ms']} ms, bound {row['bound_ms']:.6f} ms")
        # -- window_scan, sliding (timed) and fixed ----------------------------
        lim = limit if counts.dtype == np.uint8 else 500.0
        for interpolate in (False, True):
            kind = "sliding" if interpolate else "fixed"
            kw = K.WindowState(*(x.clone() for x in windows))
            pw = K.WindowState(*(x.clone() for x in windows))
            got = ck.window_scan_packed(kw, op_d, nows_d, lim, wt,
                                        interpolate=interpolate,
                                        with_remaining=with_rem)
            want = _plain_window_scan(torch, K, pw, slots, counts, nows_d,
                                      lim, wt, interpolate, with_rem)
            torch.cuda.synchronize()
            _check_equal(f"window_scan {shape} ({kind}) out", got, want)
            _check_windows(f"window_scan {shape} ({kind})", kw, pw)
        call = (lambda: ck.window_scan_packed(kw, op_d, nows_d, lim, wt,
                                              with_remaining=with_rem))
        row = _scan_row(call, op.nbytes + 4 * k + out_bytes + 26 * d,
                        30 * k * b, 0.0)
        res[("window_scan", shape)] = row
        print(f"window_scan {shape} K={k} B={b} ({d} distinct slots), "
              f"sliding and fixed: equal to plain; {row['ms']:.4f} ms, "
              f"device {row['device_ms']} ms, bound {row['bound_ms']:.6f} ms")
    return res


def _scan_row(call, nbytes, ops, err) -> dict:
    ms = _median_ms(call, inner=5)
    dev_ms = _device_ms(call, ["scan_kernel"])
    bound_ms, bound_by = _bound_ms(nbytes, ops)
    return dict(ms=ms, device_ms=dev_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


#: The bulk lane's one-batch chunks (K = 1) at the widths a store sends, as
#: :func:`route_shapes` times them.
ROUTE_WIDTHS = (8, 16, 32, 64, 256, 1024, 4096)
#: The three routes of a K = 1 chunk: the scan padded to ``max_batch`` (as
#: the JAX store launches it), the scan padded to its rows, and the flush
#: with the host's same-slot prefix (the port's store).
ROUTES = ("scan at 4096", "scan at its rows", "flush")


def _route_operand(K, route, slots, counts, now):
    """One route's operand for ``rows`` valid rows: the fused ``u8[1, B,
    5]`` scan operand (B = 4096, or the rows padded to a power of two >= 8),
    or the flush's ``i32[4, B]`` with the host's prefix."""
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
        _pad_size,
    )

    rows = len(slots)
    b = BATCH if route == "scan at 4096" else _pad_size(rows, floor=8)
    s = np.full(b, -1, np.int32)
    s[:rows] = slots
    c = np.zeros(b, np.int32)
    c[:rows] = counts
    if route != "flush":
        return K.pack_compact5(s[None], c.astype(np.uint8)[None]), s, c
    packed = np.zeros((4, b), np.int32)
    packed[0], packed[1], packed[2] = s, c, now
    packed[3, :rows] = _duplicate_prefix_host(s[:rows], c[:rows])
    return packed, s, c


def route_shapes(torch, K, ck, dev) -> list:
    """The bulk lane's K = 1 chunk on its three routes (:data:`ROUTES`), at
    each of :data:`ROUTE_WIDTHS` valid rows with distinct and with
    Zipf(1.2) slots, on 2^24-slot bucket and sliding-window tables: each
    against its plain version (the scan's per-batch loop, the flush's
    ``acquire_batch_packed`` / ``window_acquire_batch_packed``: grants,
    ``exists`` and ``last_ts`` / ``window_idx`` equal, remaining and tokens
    within atol 1e-4, every window field equal), with its CUDA-event ms, its
    device ms and the bound of its valid rows (16 B of operand and 8 B of
    reply a row, 18 or 26 B a distinct slot)."""
    rng = np.random.default_rng(SEED + 11)
    n, now = N_SLOTS, 2_000_000 + 300
    cap, rate = 100.0, 10 / 1024
    wt, limit = WINDOW_TICKS, float(WINDOW_LIMIT)
    idx = (now // wt + rng.choice([-2, -1, 0, 0, 1], n)).astype(np.int32)
    tables = {
        "bucket": (K.BucketState, (
            torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                         device=dev),
            torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                         device=dev),
            torch.tensor(rng.random(n) < 0.7, device=dev))),
        "window": (K.WindowState, (
            torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                         device=dev),
            torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                         device=dev),
            torch.tensor(idx, device=dev),
            torch.tensor(rng.random(n) < 0.7, device=dev))),
    }
    out = []
    for rows in ROUTE_WIDTHS:
        for dist in ("distinct", "Zipf(1.2)"):
            slots = (rng.choice(n, rows, replace=False) if dist == "distinct"
                     else (rng.zipf(1.2, rows) - 1) % n).astype(np.int32)
            counts = rng.integers(1, 40, rows).astype(np.int32)
            d = len(np.unique(slots))
            for kind, (cls, table) in tables.items():
                for route in ROUTES:
                    op, s, c = _route_operand(K, route, slots, counts, now)
                    op_d = torch.from_numpy(op).to(dev)
                    nows_d = torch.tensor([now], dtype=torch.int32,
                                          device=dev)
                    ks = cls(*(x.clone() for x in table))
                    ps = cls(*(x.clone() for x in table))
                    if kind == "bucket" and route == "flush":
                        call = functools.partial(ck.acquire_packed, ks, op_d,
                                                 cap, rate)
                        want = K.acquire_batch_packed(ps, op_d, cap, rate)[1]
                    elif kind == "bucket":
                        call = functools.partial(ck.acquire_scan_packed, ks,
                                                 op_d, nows_d, cap, rate)
                        want = K.acquire_scan_packed(
                            ps, torch.from_numpy(s[None]).to(dev),
                            torch.from_numpy(c[None]).to(dev), nows_d, cap,
                            rate)[1][0]
                    elif route == "flush":
                        call = functools.partial(ck.window_packed, ks, op_d,
                                                 limit, wt)
                        want = K.window_acquire_batch_packed(
                            ps, op_d, limit, wt)[1]
                    else:
                        call = functools.partial(ck.window_scan_packed, ks,
                                                 op_d, nows_d, limit, wt)
                        want = _plain_window_scan(torch, K, ps, s[None],
                                                  c[None], nows_d, limit, wt,
                                                  True, True)[0]
                    got = call()
                    got = got if route == "flush" else got[0]
                    torch.cuda.synchronize()
                    what = f"{kind} K=1 {route}, {rows} {dist} rows"
                    _check_equal(f"{what} grants", got[0], want[0])
                    err = _check_close(f"{what} remaining", got[1], want[1])
                    for field in ks._fields:
                        if field == "tokens":
                            err = max(err, _check_close(f"{what} tokens",
                                                        ks.tokens, ps.tokens))
                        else:
                            _check_equal(f"{what} {field}",
                                         getattr(ks, field),
                                         getattr(ps, field))
                    slot_b = 18 if kind == "bucket" else 26
                    names = FLUSH_KERNELS if route == "flush" else \
                        ["scan_kernel"]
                    row = _shape_row(call, names, 24 * rows + slot_b * d,
                                     15 * rows)
                    out.append({"table": kind, "route": route, "rows": rows,
                                "slots": dist, "b": len(s), "distinct": d,
                                "max_abs_err": err, **row})
                    print(f"{what} (B={len(s)}, {d} distinct slots): "
                          f"equal to plain, max abs err {err!r}; "
                          f"{row['ms']:.5f} ms, device {row['device_ms']} "
                          f"ms, bound {row['bound_ms']:.7f} ms")
                    del ks, ps
    return out


def scan_bench() -> int:
    """``python3 chip_smoke.py --scan-bench``: only :func:`route_shapes`
    and :func:`scan_shapes`, on the package beside this file (copy the
    script into another checkout to time that checkout's kernels). Prints
    the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    card = _card_line()
    print(card)
    ck.build(["acquire", "window"])
    routes = route_shapes(torch, K, ck, torch.device("cuda"))
    res = scan_shapes(torch, K, ck, torch.device("cuda"))
    print(json.dumps({"card": card, "route_shapes": routes, "scan_shapes": [
        {"kernel": kern, "shape": shape, **row}
        for (kern, shape), row in res.items()]}))
    return 0


#: The semaphore and two-level kernels' names in a profile (their warp and
#: block forms).
SEMA_KERNELS = ["sema_"]
HIER_KERNELS = ["hier_"]
#: The shapes of :func:`admission_shapes`, as the paths launch them.
SEMA_SHAPES = ("1 valid row (B=8)", "32 rows, Zipf (B=32)",
               "4096 distinct", "4096 repeats, releases, probes, padding",
               "4096 on one hot slot")
HIER_SHAPES = ("1 valid row (B=4096, as the parent's store pads)",
               "1 valid row (B=8)", "32 rows of one tenant (B=32)",
               "64 LLM rows (B=64)", "4096 LLM rows",
               "4096 rows of one tenant", "4096 distinct keys and tenants")


def _sema_shape(rng, shape: str, n: int, now: int) -> np.ndarray:
    """One semaphore shape's operand ``i32[4, B]``."""
    b = 8 if shape.startswith("1 valid") else (
        32 if shape.startswith("32") else BATCH)
    deltas = rng.integers(-2, 4, b).astype(np.int32)
    limits = rng.integers(0, 9, b).astype(np.int32)
    if shape.startswith("1 valid"):
        slots = np.full(b, -1, np.int32)
        slots[0] = rng.integers(0, n)
        deltas[0] = 1
    elif shape.startswith("32"):
        slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
    elif shape == "4096 distinct":  # the bulk lane: one permit a key
        slots = rng.choice(n, b, replace=False).astype(np.int32)
        deltas[:] = 1
        limits[:] = 5
    elif shape.startswith("4096 on one hot"):
        slots = np.full(b, int(rng.integers(0, n)), np.int32)
        deltas = rng.integers(0, 3, b).astype(np.int32)
        limits[:] = 1000
    else:  # as admission_cases' B = 4096
        slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
        slots[: b // 4] = slots[b // 4]
        slots[rng.permutation(b)[: b // 32]] = -1
        slots[rng.permutation(b)[: b // 64]] = n + 7
        deltas[:3] = (1, -1, 0)
    return np.stack([slots, deltas, limits, np.full(b, now, np.int32)])


def _hier_shape(rng, shape: str, nc: int, np_: int, now: int) -> np.ndarray:
    """One two-level shape's operand ``i32[4, B]``: child slots are the LLM
    workload's keys (dense ids spread over the child table), parents its
    tenants."""
    b = {"1 valid row (B=8)": 8, "32 rows of one tenant (B=32)": 32,
         "64 LLM rows (B=64)": 64}.get(shape, BATCH)
    tenants, keys, costs, _ = _llm_workload(LLM_SEED, b)
    spread = np.int64(2654435761)
    cs = (_dense_ids(keys).astype(np.int64) * spread % nc).astype(np.int32)
    ps = (_dense_ids(tenants).astype(np.int64) * 7919 % np_).astype(np.int32)
    if shape.startswith("1 valid"):
        cs[1:] = ps[1:] = -1
    elif "one tenant" in shape:
        ps[:] = ps[0]
    elif shape.startswith("4096 distinct"):
        cs = rng.choice(nc, b, replace=False).astype(np.int32)
        ps = rng.choice(np_, b, replace=False).astype(np.int32)
    return np.stack([cs, costs.astype(np.int32), np.full(b, now, np.int32),
                     ps])


def _shape_row(call, names, nbytes, ops) -> dict:
    """Times of one shape."""
    bound_ms, bound_by = _bound_ms(nbytes, ops)
    return dict(ms=_median_ms(call, inner=20),
                device_ms=_device_ms(call, names), bound_ms=bound_ms,
                bound_by=bound_by)


def admission_shapes(torch, K, ck, dev) -> list:
    """``sema_packed`` on a 2^20-slot table and ``acquire_hierarchical`` on
    a 2^24-slot child and a 2^18-slot parent table at each shape of
    :data:`SEMA_SHAPES` and :data:`HIER_SHAPES`, against the plain versions:
    replies and every integer state field equal, tokens within atol 1e-4.
    Prints and returns, per shape, the CUDA-event ms, the profiler's device
    ms and the bound (the 16 B operand row and 8 B reply of each of the B
    rows, 18 B per distinct slot of each table)."""
    rng = np.random.default_rng(SEED + 8)
    now = 3_000_000
    out = []
    n = SEMA_SLOTS
    sema = (torch.tensor(rng.integers(0, 6, n).astype(np.int32), device=dev),
            torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                         device=dev),
            torch.tensor(rng.random(n) < 0.6, device=dev))
    for shape in SEMA_SHAPES:
        packed = _sema_shape(rng, shape, n, now)
        b = packed.shape[1]
        op = torch.from_numpy(packed).to(dev)
        _, want = K.sema_batch_packed(
            ps := K.SemaState(*(x.clone() for x in sema)), op)
        ks = K.SemaState(*(x.clone() for x in sema))
        got = ck.sema_packed(ks, op)
        torch.cuda.synchronize()
        _check_equal(f"sema_packed {shape} replies", got, want)
        for name in ("active", "last_ts", "exists"):
            _check_equal(f"sema_packed {shape} {name}", getattr(ks, name),
                         getattr(ps, name))
        slots = packed[0]
        d = len(np.unique(slots[(slots >= 0) & (slots < n)]))
        row = _shape_row(lambda: ck.sema_packed(ks, op), SEMA_KERNELS,
                         24 * b + 18 * d, 12 * b)
        out.append({"kernel": "sema_packed", "shape": shape, "b": b,
                    "distinct": d, "granted": int(want[0].sum()),
                    "max_abs_err": 0.0, **row})
        print(f"sema_packed {shape} (B={b}, {d} distinct slots, "
              f"{int(want[0].sum())} ok): equal to plain; {row['ms']:.5f} ms, "
              f"device {row['device_ms']} ms, bound {row['bound_ms']:.7f} ms")
    del sema, ks, ps
    nc, np_ = N_SLOTS, LLM_SLOTS
    ccap, pcap = LLM_BUDGETS
    per_tick = LLM_RATE / 1024

    def bucket(m, cap):
        return (torch.tensor(rng.uniform(cap / 2, cap, m).astype(np.float32),
                             device=dev),
                torch.tensor(rng.integers(now - 3000, now, m).astype(
                    np.int32), device=dev),
                torch.tensor(rng.random(m) < 0.6, device=dev))
    ctab, ptab = bucket(nc, ccap), bucket(np_, pcap)
    args = (ccap, per_tick, pcap, per_tick)
    for shape in HIER_SHAPES:
        packed = _hier_shape(rng, shape, nc, np_, now)
        b = packed.shape[1]
        op = torch.from_numpy(packed).to(dev)
        pc, pp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
        _, _, want = K.acquire_hierarchical_packed(pc, pp, op, *args)
        kc, kp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
        got = ck.acquire_hierarchical(kc, kp, op, *args)
        torch.cuda.synchronize()
        what = f"acquire_hierarchical {shape}"
        _check_equal(f"{what} grants", got[0], want[0])
        err = _check_close(f"{what} remaining", got[1], want[1])
        for name, kt, pt in (("child", kc, pc), ("parent", kp, pp)):
            err = max(err, _check_close(f"{what} {name} tokens", kt.tokens,
                                        pt.tokens))
            _check_equal(f"{what} {name} last_ts", kt.last_ts, pt.last_ts)
            _check_equal(f"{what} {name} exists", kt.exists, pt.exists)
        ok = (packed[0] >= 0) & (packed[3] >= 0)
        d = (len(np.unique(packed[0][ok])) + len(np.unique(packed[3][ok])))
        row = _shape_row(lambda: ck.acquire_hierarchical(kc, kp, op, *args),
                         HIER_KERNELS, 24 * b + 18 * d, 30 * b)
        out.append({"kernel": "acquire_hierarchical", "shape": shape,
                    "b": b, "distinct": d, "granted": int(want[0].sum()),
                    "max_abs_err": err, **row})
        print(f"acquire_hierarchical {shape} (B={b}, {d} distinct slots, "
              f"{int(want[0].sum())} granted): equal to plain, max abs err "
              f"{err!r}; {row['ms']:.5f} ms, device {row['device_ms']} ms, "
              f"bound {row['bound_ms']:.7f} ms")
    return out


def admission_bench() -> int:
    """``python3 chip_smoke.py --admission-bench``: only
    :func:`admission_shapes`, on the package beside this file (copy the
    script into another checkout to time that checkout's kernels). Prints
    the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    card = _card_line()
    print(card)
    ck.build(["sema", "admission"])
    rows = admission_shapes(torch, K, ck, torch.device("cuda"))
    print(json.dumps({"card": card, "admission_shapes": rows}))
    return 0


#: The flush kernels' names in a profile (warp, block and wide forms; the
#: parent's one ``flush_kernel``).
FLUSH_KERNELS = ["flush_"]
#: The shapes of :func:`flush_shapes`, as the store launches them (it pads a
#: flush to a power of two >= 8 rows; the parent's store padded to 4096).
FLUSH_SHAPES = ("1 valid row (B=8)",
                "1 valid row (B=4096, as the parent's store pads)",
                "12 Zipf rows (B=16)", "32 Zipf rows (B=32)",
                "64 Zipf rows (B=64)", "256 Zipf rows (B=256)",
                "2048 Zipf rows (B=2048)", "4096 Zipf rows", "4096 distinct")


def _flush_rows(rng, shape: str, n: int):
    """One flush shape's requests: ``(slots, counts)``, padding -1."""
    b = int(re.search(r"B=(\d+)", shape).group(1)) if "B=" in shape \
        else BATCH
    valid = 1 if shape.startswith("1 valid") else int(shape.split()[0])
    slots = np.full(b, -1, np.int32)
    if shape.endswith("distinct"):
        slots[:valid] = rng.choice(n, valid, replace=False)
    else:
        slots[:valid] = (rng.zipf(1.2, valid) - 1) % n
    counts = np.zeros(b, np.int32)
    counts[:valid] = rng.integers(1, 6, valid)
    return slots, counts


def _flush_operands(slots, counts, now):
    """The store's two operands for the same requests: ``i32[4, B]`` with
    the host's same-slot prefix, and the coalesced ``i32[5, B]`` (one group
    a slot, n its requests, prefix 0)."""
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
    )

    b = len(slots)
    valid = slots >= 0
    packed = np.zeros((4, b), np.int32)
    packed[0], packed[1], packed[2] = slots, counts, now
    packed[3][valid] = _duplicate_prefix_host(slots[valid], counts[valid])
    uniq, first, sizes = np.unique(slots[valid], return_index=True,
                                   return_counts=True)
    packed5 = np.zeros((5, b), np.int32)
    packed5[0] = -1
    g = len(uniq)
    packed5[0, :g], packed5[2] = uniq, now
    packed5[1, :g] = counts[valid][first]
    packed5[4, :g] = sizes
    return packed, packed5


def flush_shapes(torch, K, ck, dev, exact=True) -> list:
    """``acquire_packed``, ``acquire_grouped``, ``window_packed`` and
    ``window_grouped`` (sliding) on 2^24-slot tables at each shape of
    :data:`FLUSH_SHAPES`, against the plain versions: out and every state
    field equal (``exact``; else remaining and tokens within atol 1e-4, as
    a parent's atomic adds leave them).
    Prints and returns, per shape, the CUDA-event ms, the profiler's device
    ms and the bound (16 B a row of the operand, 20 B grouped, and 8 B of
    reply; 18 B per distinct bucket slot, 26 B per window slot)."""
    rng = np.random.default_rng(SEED + 9)
    n, now, cap, rate = N_SLOTS, 3_000_000, 100.0, 10 / 1024
    wt, limit = WINDOW_TICKS, float(WINDOW_LIMIT)
    wnow = now + 300
    bucket = (torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                           device=dev),
              torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                           device=dev),
              torch.tensor(rng.random(n) < 0.7, device=dev))
    idx = (wnow // wt + rng.choice([-2, -1, 0, 0, 1], n)).astype(np.int32)
    window = (torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                           device=dev),
              torch.tensor(rng.integers(0, 60, n).astype(np.float32),
                           device=dev),
              torch.tensor(idx, device=dev),
              torch.tensor(rng.random(n) < 0.7, device=dev))
    kernels = {
        "acquire_packed": (K.BucketState, bucket, K.acquire_batch_packed,
                           (cap, rate), 4, 18, 15),
        "acquire_grouped": (K.BucketState, bucket,
                            K.acquire_batch_packed_grouped, (cap, rate), 5,
                            18, 18),
        "window_packed": (K.WindowState, window,
                          K.window_acquire_batch_packed, (limit, wt), 4, 26,
                          30),
        "window_grouped": (K.WindowState, window,
                           K.window_acquire_batch_packed_grouped,
                           (limit, wt), 5, 26, 30),
    }
    out = []
    for shape in FLUSH_SHAPES:
        slots, counts = _flush_rows(rng, shape, n)
        packed, packed5 = _flush_operands(slots, counts, now)
        for name, (cls, table, plain_fn, args, rows, slot_b, ops) in \
                kernels.items():
            op = packed5 if rows == 5 else packed
            window = name.startswith("window")
            if window:
                op = op.copy()
                op[2] = wnow
            op_d = torch.from_numpy(op).to(dev)
            ks = cls(*(x.clone() for x in table))
            ps = cls(*(x.clone() for x in table))
            call = functools.partial(getattr(ck, name), ks, op_d, *args)
            got = call()
            _, want = plain_fn(ps, op_d, *args)
            torch.cuda.synchronize()
            what = f"{name} {shape}"
            _check_equal(f"{what} grants", got[0], want[0])
            err = 0.0
            float_fields = ("tokens", "curr_count")
            for field in ks._fields:
                if exact or field not in float_fields:
                    _check_equal(f"{what} {field}", getattr(ks, field),
                                 getattr(ps, field))
                else:
                    err = max(err, _check_close(f"{what} {field}",
                                                getattr(ks, field),
                                                getattr(ps, field)))
            if exact:
                _check_equal(f"{what} remaining", got[1], want[1])
            else:
                err = max(err, _check_close(f"{what} remaining", got[1],
                                            want[1]))
            valid = op[0] >= 0
            d = len(np.unique(op[0][valid]))
            row = _shape_row(call, FLUSH_KERNELS,
                             (4 * rows + 8) * op.shape[1] + slot_b * d,
                             ops * op.shape[1])
            out.append({"kernel": name, "shape": shape,
                        "b": int(op.shape[1]), "distinct": d,
                        "granted": float(want[0].sum()), "max_abs_err": err,
                        **row})
            print(f"{what} (B={op.shape[1]}, {d} distinct slots, "
                  f"{float(want[0].sum())} granted): equal to plain, max abs "
                  f"err {err!r}; {row['ms']:.5f} ms, device "
                  f"{row['device_ms']} ms, bound {row['bound_ms']:.7f} ms")
    return out


def window_traffic() -> int:
    """``python3 chip_smoke.py --window-traffic [--gc-freeze]``: only
    :func:`window_path`, on the package beside this file (copy the script
    into another checkout to run that checkout's); ``--gc-freeze`` freezes
    the collector's generations before the arrivals. Prints the card and
    the path's lines."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributedratelimiting.redis_tpu_torch as pkg
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

    card = _card_line()
    print(card)
    ck.build(["window"])
    asyncio.run(window_path(torch, ck, pkg, card,
                            freeze_gc="--gc-freeze" in sys.argv[2:]))
    return 0


def flush_bench() -> int:
    """``python3 chip_smoke.py --flush-bench``: only :func:`flush_shapes`,
    on the package beside this file (copy the script into another checkout
    to time that checkout's kernels: there remaining and tokens are held
    within atol 1e-4). Prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    card = _card_line()
    print(card)
    ck.build(["acquire", "window"])
    rows = flush_shapes(torch, K, ck, torch.device("cuda"), exact=False)
    print(json.dumps({"card": card, "flush_shapes": rows}))
    return 0


#: The counter sync's and the debit's kernels in a profile: ``csrc/
#: tally.cuh``'s warp, block and grid kernels by their policy, the fill of
#: the grid path's int32 claim words (``torch.zeros``: a memset or a
#: ``FillFunctor<int>``), and a parent's ``sync_kernel`` / ``debit_kernel``.
SYNC_KERNELS = ["SyncPolicy", "sync_kernel", "FillFunctor<int>", "Memset"]
DEBIT_KERNELS = ["DebitPolicy", "debit_kernel", "FillFunctor<int>", "Memset"]


def _launched(fn) -> list:
    """The device activities of one call of ``fn``, by name, each with its
    device µs (a profile of one call after a warm one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:80], round(getattr(e, "self_device_time_total", 0.0), 2))
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0]


#: The shapes of :func:`tally_shapes`: the sync's and the debit's launches
#: as the store sends them (the parent's store padded a debit to >= 64); a
#: fleet of 33 to 4,096 keys sends 64 to 4,096 rows.
SYNC_SHAPES = ("sync: 1 valid row (B=8)", "sync: 12 Zipf rows (B=16)",
               "sync: 64 Zipf rows (B=64)", "sync: 256 Zipf rows (B=256)",
               "sync: 1024 Zipf rows (B=1024)",
               "sync: 4096 Zipf rows (B=4096)",
               "sync: 4096 distinct (B=4096)",
               "sync: 2^17 Zipf(1.1) rows", "sync: 2^18 Zipf(1.1) rows",
               "sync: 2^20 Zipf(1.1) rows",
               "sync: 2^20 distinct", "sync: 2^20 distinct, L2 flushed",
               "debit: 1 valid row (B=8)",
               "debit: 1 valid row (B=64, as the parent's store pads)",
               "debit: 64 rows, repeats (B=64)",
               "debit: 1024 rows, repeats (B=1024)",
               "debit: 4096 rows, repeats (B=4096)",
               "debit: 4096 distinct (B=4096)",
               "debit: 2^20 distinct of 2^24",
               "debit: 2^20 distinct of 2^24, L2 flushed")


def _device_ms_flushed(fn, kernel_names, flush, reps=20):
    """:func:`_device_ms` with the L2 written over (``flush``, 64 MB) before
    every call; the flush's own kernel is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if any(k in e.key for k in kernel_names))
    return us / 1e3 / reps if us > 0 else None


def tally_shapes(torch, K, ck, dev) -> list:
    """``sync_counters`` (2^20 counters) and ``debit_packed`` (2^24 slots)
    at each shape of :data:`SYNC_SHAPES`, on the package beside the script:
    the profiler's device ms (warm, or with the L2 flushed before every
    launch), the bound, and the max abs error of replies and values or
    tokens against the plain version on the card (r rounded adds a repeated
    slot: the plain version's are atomic)."""
    from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm

    rng = np.random.default_rng(SEED + 10)
    now, rate = 3_000_000, DECAY_PER_S / 1024
    cap, frate = 100.0, 10 / 1024
    nc, nb = COUNTER_SLOTS, N_SLOTS
    counters = (torch.tensor(rng.uniform(0, 1000, nc).astype(np.float32),
                             device=dev),
                torch.tensor(rng.uniform(0, 5000, nc).astype(np.float32),
                             device=dev),
                torch.tensor(rng.integers(now - 3000, now + 300, nc).astype(
                    np.int32), device=dev),
                torch.tensor(rng.random(nc) < 0.5, device=dev))
    buckets = (torch.tensor(rng.uniform(0, cap, nb).astype(np.float32),
                            device=dev),
               torch.tensor(rng.integers(now - 3000, now, nb).astype(
                   np.int32), device=dev),
               torch.tensor(rng.random(nb) < 0.6, device=dev))
    flush = torch.empty(2**26, dtype=torch.uint8, device=dev)
    rows = []
    for shape in SYNC_SHAPES:
        kind, rest = shape.split(": ")
        b = (int(re.search(r"B=(\d+)", rest).group(1)) if "B=" in rest
             else 2 ** int(re.search(r"2\^(\d+)", rest).group(1)))
        if kind == "sync":
            n = nc
            distinct = "distinct" in rest
            valid = (1 if rest.startswith("1 valid")
                     else 12 if rest.startswith("12 ") else None)
            packed = _sync_packed(rng, b, n, now, distinct, valid=valid)
            cls, tab, names = K.CounterState, counters, SYNC_KERNELS
            plain = functools.partial(K.sync_batch_packed,
                                      decay_rate_per_tick=rate)
            call = functools.partial(ck.sync_counters,
                                     decay_rate_per_tick=rate)
            field, row_b, slot_b = "value", 20, 26
        else:
            n = nb
            if "distinct" in rest:
                slots = rng.choice(n, b, replace=False).astype(np.int32)
                amounts = rng.uniform(0, 120, b).astype(np.float32)
            else:
                slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
                amounts = rng.uniform(-20, 60, b).astype(np.float32)
            if rest.startswith("1 valid"):
                slots[1:] = -1
            t = torch.from_numpy(slots)
            pre = bm.duplicate_prefix_float(t, torch.from_numpy(amounts),
                                            t >= 0)
            packed = np.stack([slots, amounts.view(np.int32),
                               np.full(b, now, np.int32),
                               pre.numpy().view(np.int32)])
            cls, tab, names = K.BucketState, buckets, DEBIT_KERNELS
            plain = functools.partial(K.debit_batch_packed, capacity=cap,
                                      fill_rate_per_tick=frate)
            call = functools.partial(ck.debit_packed, capacity=cap,
                                     fill_rate_per_tick=frate)
            field, row_b, slot_b = "tokens", 24, 18
        op = torch.from_numpy(packed).to(dev)
        ok = (packed[0] >= 0) & (packed[0] < n)
        d = len(np.unique(packed[0][ok]))
        bound_ms, bound_by = _bound_ms(row_b * b + slot_b * d, 12 * b)
        ks = cls(*(x.clone() for x in tab))
        ps = cls(*(x.clone() for x in tab))
        got = call(ks, op)
        _, want = plain(ps, op)
        torch.cuda.synchronize()
        err = max(_max_err(got, want),
                  _max_err(getattr(ks, field), getattr(ps, field)))
        del ps
        fn = functools.partial(call, ks, op)
        dev_ms = (_device_ms_flushed(fn, names, flush)
                  if "flushed" in rest else _device_ms(fn, names))
        rows.append({"shape": shape, "b": b, "distinct": d,
                     "device_ms": dev_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err})
        print(f"{shape} (B={b}, {d} distinct slots): device {dev_ms} ms, "
              f"bound {bound_ms:.7f} ms ({bound_by}), max abs err {err!r}")
        del ks
        torch.cuda.empty_cache()
    return rows


#: ``sweep_counters``'s device activities in a profile: its kernel and, in
#: a checkout whose wrapper zeroes the tile counts first, that zeroing (a
#: memset or a ``FillFunctor<int>``).
SWEEP_COUNTER_KERNELS = ["sweep_counters", "FillFunctor<int>", "Memset"]
#: The counter sweep's sizes: tails shorter than a thread's 16 slots, a
#: table smaller than a tile, one tile, a last partial tile, and the
#: approximate path's 2^20 counters.
SWEEP_SIZES = (1, 15, 16, 17, 4101, 32768, 2**16 + 3, 2**20, 2**20 + 7)


def sweep_counter_shapes(torch, K, ck, dev) -> list:
    """``sweep_counters`` at each of :data:`SWEEP_SIZES`, on the package
    beside the script: mask, tile counts and ``exists`` equal to the plain
    version's on the card (``last_ts`` over two days either side of the
    86400 s TTL, half the counters live), and the whole function's device
    ms (every launch the wrapper makes, a zeroing of the counts too), warm,
    with its bound (7 B a slot and 4 B a tile)."""
    rng = np.random.default_rng(SEED + 12)
    now, ttl = 200_000_000, 86400 * 1024
    rows = []
    for n in SWEEP_SIZES:
        z = torch.zeros(n, device=dev)
        last = torch.tensor(rng.integers(now - 2 * ttl, now + 300,
                                         n).astype(np.int32), device=dev)
        exists0 = torch.tensor(rng.random(n) < 0.5, device=dev)
        ks = K.CounterState(z, z, last, exists0.clone())
        ps = K.CounterState(z, z, last, exists0.clone())
        mask, counts = ck.sweep_counters(ks, now)
        _, expired = K.sweep_counters(ps, now)
        torch.cuda.synchronize()
        _check_equal(f"sweep_counters N={n} mask", mask.bool(), expired)
        _check_equal(f"sweep_counters N={n} exists", ks.exists, ps.exists)
        want = torch.nn.functional.pad(
            expired.int(), (0, counts.numel() * ck.TILE - n)).view(
                -1, ck.TILE).sum(1)
        _check_equal(f"sweep_counters N={n} tile counts", counts, want.int())

        def call(ks=ks, exists0=exists0):
            ks.exists.copy_(exists0)  # a Memcpy DtoD: not counted
            return ck.sweep_counters(ks, now)

        dev_ms = _device_ms(call, SWEEP_COUNTER_KERNELS)
        bound_ms, bound_by = _bound_ms(7 * n + 4 * counts.numel(), 4 * n)
        rows.append({"n": n, "expired": int(counts.sum()),
                     "device_ms": dev_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": 0.0})
        print(f"sweep_counters N={n}: expired {int(counts.sum())}, equal to "
              f"plain; device {dev_ms} ms (whole function), bound "
              f"{bound_ms:.7f} ms ({bound_by})")
    return rows


def sync_bench() -> int:
    """``python3 chip_smoke.py --sync-bench``: only
    :func:`sweep_counter_shapes` and :func:`tally_shapes`, on the package
    beside this file (copy the script into another checkout to time that
    checkout's kernels). Prints the card, one JSON line of the shapes, and
    the device line of the default run last."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    card = _card_line()
    print(card)
    ck.build(["counter", "admission"])
    sweeps = sweep_counter_shapes(torch, K, ck, torch.device("cuda"))
    rows = tally_shapes(torch, K, ck, torch.device("cuda"))
    # What one slot-major launch runs on the card, the claim words' fill
    # included (the names above must cover all of it).
    dev = torch.device("cuda")
    n = COUNTER_SLOTS
    st = K.CounterState(torch.zeros(n, device=dev), torch.zeros(n, device=dev),
                        torch.zeros(n, dtype=torch.int32, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev))
    op = torch.from_numpy(_sync_packed(np.random.default_rng(SEED), n, n, 1,
                                       True)).to(dev)
    print("one 2^20-row sync launches:",
          _launched(lambda: ck.sync_counters(st, op, 0.001)))
    print("one 2^20-counter sweep launches:",
          _launched(lambda: ck.sweep_counters(st, 1)))
    print(json.dumps({"card": card, "sync_shapes": rows,
                      "sweep_counter_shapes": sweeps}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _sync_packed(rng, b, n, now, distinct, slot0=False, valid=None):
    """A counter-sync operand ``i32[3, B]``: Zipf(1.1) slots (duplicates) or
    distinct ones, 2% padding (``slot0``: 30% padding and out-of-range rows
    and slot 0 a real slot of ~5% of the rows; ``valid``: only the first
    ``valid`` rows), float counts bitcast, the tick."""
    if distinct:
        slots = rng.permutation(n)[:b].astype(np.int32)
    else:
        slots = ((rng.zipf(ZIPF_S, b) - 1) % n).astype(np.int32)
    slots[rng.random(b) < 0.02] = -1
    if slot0:
        slots[rng.random(b) < 0.2] = -1
        slots[rng.random(b) < 0.1] = n + 5
        slots[rng.random(b) < 0.05] = 0
        slots[0] = 0
    if valid is not None:
        slots[valid:] = -1
    counts = rng.uniform(0, 50, b).astype(np.float32)
    counts[slots < 0] = 0.0
    return np.stack([slots, counts.view(np.int32), np.full(b, now, np.int32)])


def _check_twice(what, call, states) -> None:
    """Run ``call`` on each of two clones of one table: replies and every
    state field equal bit for bit (one writer a slot, no float atomics)."""
    import torch

    outs = [call(st) for st in states]
    torch.cuda.synchronize()
    _check_equal(f"{what} twice: replies", outs[0], outs[1])
    for field in states[0]._fields:
        _check_equal(f"{what} twice: {field}", getattr(states[0], field),
                     getattr(states[1], field))


def counter_cases(torch, K, ck, dev, rng) -> dict:
    """``sync_counters`` and ``sweep_counters`` against their plain versions
    on a counter table of 2^20 slots: half live, stored ticks on both sides
    of ``now`` (a clock behind some of them). Every sync shape also runs
    twice on clones of the table, which must agree bit for bit."""
    n, now, rate = COUNTER_SLOTS, 3_000_000, DECAY_PER_S / 1024
    table = (torch.tensor(rng.uniform(0, 1000, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.uniform(0, 5000, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now + 300, n).astype(
                 np.int32), device=dev),
             torch.tensor(rng.random(n) < 0.5, device=dev))
    res = {}
    sync = {}
    shapes = {}
    for label, b, distinct, slot0 in (
            ("Zipf(1.1)", n, False, False), ("distinct", n, True, False),
            ("B = 8", 8, False, False), ("B = 32", 32, False, False),
            ("B = 33", 33, False, False), ("B = 4096", 4096, False, False),
            ("2^17 Zipf(1.1)", 2**17, False, False),
            ("2^22 + 1 Zipf(1.1)", 2**22 + 1, False, False),
            ("slot 0 and padding, B = 4096", 4096, False, True),
            ("slot 0 and padding, B = 2^17", 2**17, False, True)):
        packed = _sync_packed(rng, b, n, now, distinct, slot0)
        valid = (packed[0] >= 0) & (packed[0] < n)
        uniq, reps = np.unique(packed[0][valid], return_counts=True)
        op = torch.from_numpy(packed).to(dev)
        ks = K.CounterState(*(x.clone() for x in table))
        ps = K.CounterState(*(x.clone() for x in table))
        got = ck.sync_counters(ks, op, rate)
        _, want = K.sync_batch_packed(ps, op, rate)
        torch.cuda.synchronize()
        # Padding rows' replies read slot 0 as it was before the launch.
        _check_equal(f"sync {label} replies", got, want)
        _check_equal(f"sync {label} period", ks.period, ps.period)
        _check_equal(f"sync {label} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"sync {label} exists", ks.exists, ps.exists)
        if (reps > 1).any():
            # The plain version's index_add_ on the card adds duplicates in
            # atomic order; the kernel rounds each slot's sum once.
            err, tol = _check_repeated_adds(
                f"sync {label} value", packed[0], ks.value.cpu().numpy(),
                ps.value.cpu().numpy())
        else:
            _check_equal(f"sync {label} value", ks.value, ps.value)
            err, tol = 0.0, 0.0
        _check_twice(f"sync {label}", lambda st: ck.sync_counters(st, op,
                                                                  rate),
                     [K.CounterState(*(x.clone() for x in table))
                      for _ in range(2)])
        ms = _median_ms(lambda: ck.sync_counters(ks, op, rate),
                        inner=5 if b > 8 else 20)
        plain_ms = _median_ms(lambda: K.sync_batch_packed(ps, op, rate),
                              reps=5, warmup=1)
        dev_ms = _device_ms(lambda: ck.sync_counters(ks, op, rate),
                            SYNC_KERNELS)
        # Bytes: the operand and the reply (20 B a row), 13 B of state read
        # and 13 B written per distinct slot. ~12 operations a row.
        sync[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=None, bytes=20 * b + 26 * len(uniq),
                           ops=12 * b, device_ms=dev_ms)
        bound_ms, bound_by = _bound_ms(sync[label]["bytes"], 12 * b)
        shapes[f"{label} (B={b})"] = dict(
            ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=err)
        print(f"sync_counters ({label}) B={b} ({len(uniq)} distinct slots, "
              f"max repeat {reps.max()}): replies, period, last_ts, exists "
              f"equal to plain, value max abs err {err!r} (that slot's limit "
              f"{tol!r}), two launches bit-equal; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, device time {dev_ms} ms)")
    # The fleet sync of the main path sends distinct keys.
    res["sync_counters"] = dict(sync["distinct"], max_abs_err=max(
        r["max_abs_err"] for r in sync.values()), shapes=shapes)
    exact_sums_case(torch, K, ck, dev, rng, table, now, rate)

    # sweep_counters over the table: last touches up to two days back.
    last = torch.tensor(rng.integers(now - 2 * 86400 * 1024, now + 300,
                                     n).astype(np.int32), device=dev)
    exists0 = table[3]
    ks = K.CounterState(table[0], table[1], last, exists0.clone())
    ps = K.CounterState(table[0], table[1], last, exists0.clone())
    mask, counts = ck.sweep_counters(ks, now)
    _, expired = K.sweep_counters(ps, now)
    torch.cuda.synchronize()
    _check_equal("sweep_counters mask", mask.bool(), expired)
    _check_equal("sweep_counters exists", ks.exists, ps.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(
            -1, ck.TILE).sum(1)
    _check_equal("sweep_counters tile counts", counts, want_tiles.int())
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep_counters expired {n_expired}: no mix")
    ms = _median_ms(lambda: ck.sweep_counters(ks, now),
                    setup=lambda: ks.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_counters(ps, now),
                          setup=lambda: ps.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_counters(ks, now),
                        SWEEP_COUNTER_KERNELS)
    # 7 B a slot (last_ts and exists read, exists and mask written) and the
    # tile counts; ~4 operations a slot (sub, max, compare, and).
    res["sweep_counters"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=7 * n + 4 * counts.numel(), ops=4 * n, device_ms=dev_ms)
    print(f"sweep_counters N={n}: expired {n_expired}, equal to plain; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} ms)")
    return res


def exact_sums_case(torch, K, ck, dev, rng, table, now, rate) -> None:
    """``sync_counters`` at B = 4096, 2^17 and 2^20 with Zipf(1.1)
    duplicates on sums that float32 holds exactly: whole-number values and
    counts (1 to 8), stored ticks on a 1024-tick grid around ``now`` so the
    decay subtracts a whole number (``rate`` · 1024 is one). No order of the
    adds rounds, so the kernel's one rounding of each slot's sum and the
    plain version's atomic adds give the same value on every slot, the
    hottest included: a count lost or added twice shows."""
    n = table[0].numel()
    if float(np.float32(rate) * 1024) != float(DECAY_PER_S):
        raise AssertionError("the decay per 1024 ticks is not whole")
    grid = (now - 1024 * rng.integers(-1, 4, n)).astype(np.int32)
    itable = (torch.tensor(rng.integers(0, 1000, n).astype(np.float32),
                           device=dev),
              table[1], torch.tensor(grid, device=dev), table[3])
    for b in (4096, 2**17, n):
        packed = _sync_packed(rng, b, n, now, distinct=False)
        counts = rng.integers(1, 9, b).astype(np.float32)
        counts[packed[0] < 0] = 0.0
        packed[1] = counts.view(np.int32)
        reps = np.bincount(packed[0][packed[0] >= 0], minlength=n)
        # Largest partial sum: a value below 1000 plus every count of the
        # slot.
        if 1000 + 8 * int(reps.max()) >= 2**24:
            raise AssertionError("a slot's sum passes 2^24: not exact")
        op = torch.from_numpy(packed).to(dev)
        ks = K.CounterState(*(x.clone() for x in itable))
        ps = K.CounterState(*(x.clone() for x in itable))
        got = ck.sync_counters(ks, op, rate)
        _, want = K.sync_batch_packed(ps, op, rate)
        torch.cuda.synchronize()
        _check_equal("sync exact sums replies", got, want)
        for name in ("value", "period", "last_ts", "exists"):
            _check_equal(f"sync exact sums {name}", getattr(ks, name),
                         getattr(ps, name))
        print(f"sync_counters (Zipf(1.1), exact sums) B={b} (max repeat "
              f"{reps.max()}): replies and every slot's value, period, "
              f"last_ts, exists equal to plain")


def scan_case(torch, K, ck, dev, rng, table, now, cap, rate) -> dict:
    """The bulk lane's kernel on one chunk (K = 32 batches of 4096) against
    the plain per-batch loop: Zipf slots with the fused u8 operand (bits
    and f32 out) and the i32 operand, and distinct slots (fused, bits).
    Returns the main path's variant (distinct slots, fused, bits) with the
    largest error of the four."""
    n = table[0].numel()
    k, b = SCAN_K, BATCH
    zipf = ((rng.zipf(1.2, (k, b)) - 1) % n).astype(np.int32)
    # Distinct slots within each batch, as a bulk call over distinct keys
    # gives them: the kernel skips the sort and the scans.
    distinct = np.stack([rng.choice(n, b, replace=False)
                         for _ in range(k)]).astype(np.int32)
    for slots in (zipf, distinct):
        slots[rng.random((k, b)) < 0.02] = -1
    nows = np.repeat(np.array([now, now + 500, now + 1500], np.int32),
                     [11, 11, k - 22])
    c8 = rng.integers(0, 40, (k, b)).astype(np.uint8)
    c32 = rng.integers(0, 1001, (k, b)).astype(np.int32)
    nows_d = torch.from_numpy(nows).to(dev)
    variants = {
        "fused, bits": (zipf, K.pack_compact5(zipf, c8), c8, False),
        "fused, f32": (zipf, K.pack_compact5(zipf, c8), c8, True),
        "i32, f32": (zipf, np.stack([zipf, c32]), c32, True),
        "fused, bits, distinct slots": (
            distinct, K.pack_compact5(distinct, c8), c8, False),
    }
    out_res = {}
    for label, (slots, op, counts, with_rem) in variants.items():
        valid = slots >= 0
        # Distinct valid slots in the chunk: each is read once and written
        # once at least (9 B each way).
        d = len(np.unique(slots[valid]))
        slots_d = torch.from_numpy(slots).to(dev)
        op_d = torch.from_numpy(op).to(dev)
        counts_d = torch.from_numpy(counts.astype(np.int32)).to(dev)
        ks = K.BucketState(*(x.clone() for x in table))
        ps = K.BucketState(*(x.clone() for x in table))
        got = ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                     with_remaining=with_rem)
        _, pout = K.acquire_scan_packed(ps, slots_d, counts_d, nows_d, cap,
                                        rate)
        torch.cuda.synchronize()
        err = _check_close(f"scan {label} tokens", ks.tokens, ps.tokens)
        _check_equal(f"scan {label} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"scan {label} exists", ks.exists, ps.exists)
        if with_rem:
            _check_equal(f"scan {label} grants", got[:, 0], pout[:, 0])
            err = max(err, _check_close(f"scan {label} remaining", got[:, 1],
                                        pout[:, 1]))
        else:
            _check_equal(f"scan {label} bits", got,
                         K.pack_grant_bits(pout[:, 0] > 0.5))
        granted = int((pout[:, 0] > 0.5).sum())
        if not 0 < granted < int(valid.sum()):  # a mix
            raise AssertionError(f"scan {label}: granted {granted}")
        call = (lambda ks=ks, op_d=op_d, with_rem=with_rem:
                ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                       with_remaining=with_rem))
        ms = _median_ms(call, inner=5)
        plain_ms = _median_ms(lambda ps=ps, slots_d=slots_d,
                              counts_d=counts_d:
                              K.acquire_scan_packed(ps, slots_d, counts_d,
                                                    nows_d, cap, rate),
                              reps=5, warmup=1)
        dev_ms = _device_ms(call, ["scan_kernel"])
        out_bytes = k * b // 8 if not with_rem else k * 2 * b * 4
        out_res[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=op.nbytes + 4 * k + out_bytes + 18 * d, ops=15 * k * b,
            device_ms=dev_ms)
        print(f"acquire_scan ({label}) K={k} B={b} ({d} distinct slots, "
              f"{granted} granted): equal to plain, max abs err {err:.3g}; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} "
              f"ms)")
    # Every row padding but two rows of one slot a batch: the hash phases,
    # the barriers and one slot's walk over 32 batches run, and next to no
    # row gathers or writes.
    pad = np.full((k, b), -1, np.int32)
    pad[:, :2] = 7
    pad = torch.from_numpy(K.pack_compact5(pad, c8)).to(dev)
    ps = K.BucketState(*(x.clone() for x in table))
    pad_ms = _median_ms(lambda: ck.acquire_scan_packed(
        ps, pad, nows_d, cap, rate, with_remaining=False), inner=5)
    print(f"acquire_scan (fused, bits) with every row padding but one "
          f"repeated slot a batch: {pad_ms:.4f} ms (hash phases, barriers "
          f"and one slot's walk; next to no gather or write)")
    # The main path's bulk sends distinct keys.
    main = dict(out_res["fused, bits, distinct slots"])
    main["max_abs_err"] = max(r["max_abs_err"] for r in out_res.values())
    return main


async def trace_chunk(torch, ck, lim, keys, card: str, state: str,
                      required: bool = True) -> None:
    """One bulk chunk of new keys (one K = 32 launch) under
    ``torch.profiler``: the device's busy share of the call's wall time (the
    union of kernel and copy intervals), the kernels it launched, and how
    far each kernel's start lies from its launch call on the host's clock.
    If ``required``, the proof that the chunk ran on the card does not go
    through the profiler's CUPTI trace: ``acquire_scan``'s launch count must
    go up by one and CUDA events around the call must read a time above 0,
    else the path fails. A trace without a kernel prints its reading as not
    measured (ROADMAP C1), whether required or not. The Chrome trace goes
    to the build directory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    scans_before = ck.launches["acquire_scan"]
    ev0, ev1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev0.record()
        res = await lim.acquire_many(keys, permits=1, with_remaining=False)
        ev1.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    event_ms = ev0.elapsed_time(ev1)
    scans = ck.launches["acquire_scan"] - scans_before
    if res.granted_count != len(keys):
        raise AssertionError("traced chunk: not every fresh key granted")
    if required and (scans != 1 or not event_ms > 0.0):
        raise AssertionError(
            f"traced chunk ({state}): {scans} acquire_scan launch(es) and "
            f"{event_ms} ms between CUDA events; the chunk did not run on "
            "the card")
    print(f"bulk chunk ({state}): {scans} acquire_scan launch, "
          f"{event_ms:.4f} ms between CUDA events around the call ({card})")
    path = ck.BUILD_DIR / "bulk_chunk_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # The function's name, without its namespace, template and arguments.
    kernels = [re.sub(r"^.*?(\w+)(<.*?>)?\(.*$", r"\1", e["name"])
               for e in device if e["cat"] == "kernel"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "Launch" in e.get("name", "")
                 and "correlation" in e.get("args", {})}
    if not kernels:
        msg = (f"no kernel in the trace ({len(launch_ts)} kernel launch "
               f"calls and {len(device)} copies or sets recorded)")
        print(f"bulk chunk under torch.profiler ({state}): not measured, "
              f"{msg}; ROADMAP C1")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if b > end:  # the union of the device intervals
            busy_us += b - max(a, end)
            end = b
    skew_us = [e["ts"] - launch_ts[e["args"]["correlation"]]
               for e in device if e["cat"] == "kernel"
               and e.get("args", {}).get("correlation") in launch_ts]
    skew = (f"kernel start - its launch call {min(skew_us):.1f} to "
            f"{max(skew_us):.1f} us" if skew_us else
            "no kernel matched to its launch call")
    print(f"bulk chunk under torch.profiler ({state}): {len(keys)} keys in "
          f"{wall_us / 1e3:.3f} ms ({card}); device busy "
          f"{busy_us / 1e3:.4f} ms = {busy_us / wall_us:.4%} of wall; "
          f"{len(kernels)} kernel launch(es) {kernels}, "
          f"{len(device) - len(kernels)} copies or sets; {skew}")


def _check_native(store) -> None:
    """Every table's key directory and the counter directory must be the
    native one: no silent fallback to the Python directory on the card."""
    from distributedratelimiting.redis_tpu_torch.runtime.directory import (
        NativeKeyDirectory,
    )

    dirs = [t.dir for t in (*store._tables.values(),
                            *store._wtables.values())] + [store._counter_dir]
    kinds = {type(d).__name__ for d in dirs}
    if kinds != {"NativeKeyDirectory"} or not all(
            isinstance(d, NativeKeyDirectory) for d in dirs):
        raise AssertionError(f"key directories are {kinds}, not native")


async def main_path(torch, ck, pkg, card: str) -> dict:
    """The port's serving path at full size; returns the kernel launches it
    made."""
    from distributedratelimiting.redis_tpu_torch.utils.tracing import (
        ProfilingSession,
    )

    clock = pkg.ManualClock(1_000_000)
    # The store's profiling seam times each host dispatch (resolve, pack,
    # upload, enqueue — not the device).
    session = ProfilingSession()
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  max_batch=BATCH, clock=clock,
                                  profiling_session=lambda: session)
    opts = pkg.TokenBucketOptions(token_limit=100, tokens_per_period=10,
                                  replenishment_period_s=1.0,
                                  instance_name="smoke")
    lim = pkg.PartitionedRateLimiter(opts, store)
    cap5 = pkg.PartitionedRateLimiter(
        pkg.TokenBucketOptions(token_limit=5, tokens_per_period=1,
                               instance_name="cap5"), store)
    await store.connect()
    # Time the host key→slot resolve inside the bulk dispatch (the table
    # exists from here on).
    resolve_s = [0.0]
    _time_calls(store._table(opts.token_limit, opts.fill_rate_per_second).dir,
                "resolve_batch", resolve_s)
    # A chunk of new keys under the profiler on the fresh table, where its
    # trace must hold the kernel, and another after the 10M-key bulk, the
    # state the path serves: there a session recorded no kernel in half of
    # the whole-script runs, stickily (ROADMAP C1), so its reading may be
    # "not measured".
    n_chunk = SCAN_K * BATCH
    await trace_chunk(torch, ck, lim, range(N_KEYS, N_KEYS + n_chunk), card,
                      "fresh table")
    session.finish()
    resolve_s[0] = 0.0
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    ck.reset_launches()

    # Bulk: 10M distinct keys, one permit each — every fresh bucket grants.
    t0 = time.perf_counter()
    res = await lim.acquire_many(range(N_KEYS), permits=1,
                                 with_remaining=False)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    bulk_gc_s = gc_clock.total
    bulk_resolve_s = resolve_s[0]
    _INPROCESS_RESOLVE_S[0] = bulk_resolve_s
    if len(res) != N_KEYS or res.granted_count != N_KEYS:
        raise AssertionError(f"bulk: {res.granted_count}/{len(res)} granted")
    dispatch_s = sum(c.duration_s for c in session.finish())
    bulk_launches = dict(ck.launches)
    # A second bulk call on 1M of them reads back remaining: 100 - 1 - 1.
    sub = list(range(0, N_KEYS, 10))
    res = await lim.acquire_many(sub, permits=1)
    if not (res.granted.all() and np.all(res.remaining == 98.0)):
        raise AssertionError("bulk: second call's remaining is not 98")
    print(f"bulk acquire_many: {N_KEYS} distinct keys in {bulk_s:.3f} s = "
          f"{N_KEYS / bulk_s:.0f} decisions/s ({card}); host dispatch "
          f"{dispatch_s:.3f} s, of which key->slot resolve "
          f"{bulk_resolve_s:.3f} s; garbage collector {bulk_gc_s:.3f} s; "
          f"kernel launches {bulk_launches}")
    await trace_chunk(torch, ck, lim,
                      range(N_KEYS + n_chunk, N_KEYS + 2 * n_chunk), card,
                      "after the 10M-key bulk", required=False)

    # Flushes: cold keys (distinct rows) and hot keys (duplicates, grouped).
    rng = np.random.default_rng(SEED)
    cold = [int(k) for k in rng.choice(np.arange(1, N_KEYS, 10), 1000,
                                       replace=False)]  # 99 tokens left
    hot = [f"hot{i}" for i in range(20)]
    asks = [h for h in hot for _ in range(150)] + cold
    order = rng.permutation(len(asks))
    cap5.available_permits("h5")  # builds the cap-5 table outside the timing
    session.finish()
    flushes0 = store.metrics.flush_latency.total
    gc0 = gc_clock.total
    t0 = time.perf_counter()
    cold_leases = await asyncio.gather(*(lim.acquire_async(k) for k in cold))
    leases = await asyncio.gather(*(lim.acquire_async(asks[i])
                                    for i in order))
    five = await asyncio.gather(*(cap5.acquire_async("h5")
                                  for _ in range(32)))
    flush_s = time.perf_counter() - t0
    flush_gc_s = gc_clock.total - gc0
    n_flush = len(cold) + len(asks) + 32
    flushes = store.metrics.flush_latency.total - flushes0
    dispatch_s = sum(c.duration_s for c in session.finish())
    got = {}
    for i, lease in zip(order, leases):
        got[asks[i]] = got.get(asks[i], 0) + bool(lease)
    # Host oracle: no time passes, so each key grants min(asks, balance).
    want = {h: 100 for h in hot}
    want.update({k: 1 for k in cold})
    if not all(cold_leases) or got != want:
        raise AssertionError("flush grants disagree with the host oracle")
    if sum(map(bool, five)) != 5:
        raise AssertionError(f"cap-5 bucket granted {sum(map(bool, five))}")
    if lim.available_permits("hot0") != 0 or \
            lim.available_permits(cold[0]) != 97:
        raise AssertionError("available_permits disagrees with the oracle")
    print(f"acquire_async flushes: {n_flush} requests in {flush_s:.3f} s = "
          f"{n_flush / flush_s:.0f} decisions/s ({card}); grants exact; "
          f"{flushes} flushes, host dispatch {dispatch_s:.3f} s, flush p50 "
          f"{store.metrics.flush_latency.p50 * 1e3:.3f} ms, p99 "
          f"{store.metrics.flush_latency.p99 * 1e3:.3f} ms, garbage collector "
          f"{flush_gc_s:.3f} s")

    # Tier-0 debit: pre-aggregated float amounts on 1M keys of the table
    # (every tenth key from 5: 99 tokens, untouched since the bulk), ONE
    # launch; then a refund (negative amounts). Held to a host float32
    # oracle: no time has passed, so each slot refills to 99 exactly.
    dkeys = [f"smoke:{i}" for i in range(5, N_KEYS, N_DEBIT_STRIDE)]
    amounts = rng.uniform(0, 150, len(dkeys)).astype(np.float32)
    d0 = ck.launches["debit_packed"]
    t0 = time.perf_counter()
    rem, short = await store.debit_many(dkeys, amounts, 100.0, 10.0)
    debit_s = time.perf_counter() - t0
    if ck.launches["debit_packed"] - d0 != 1:
        raise AssertionError("debit_many: not one launch")
    applied = np.minimum(amounts, np.float32(99.0))
    want_rem = np.float32(99.0) - applied
    if not (np.array_equal(rem.astype(np.float32), want_rem)
            and np.array_equal(short.astype(np.float32),
                               amounts - applied)):
        raise AssertionError("debit_many disagrees with the host oracle")
    refund = -(applied / np.float32(2.0))
    t0 = time.perf_counter()
    rem2, short2 = await store.debit_many(dkeys, refund, 100.0, 10.0)
    refund_s = time.perf_counter() - t0
    if not (np.array_equal(rem2.astype(np.float32), want_rem - refund)
            and not short2.any()):
        raise AssertionError("debit_many refund disagrees with the oracle")
    print(f"debit_many (tier-0): {len(dkeys)} distinct keys of the "
          f"{N_SLOTS}-slot table in one launch, {debit_s:.3f} s = "
          f"{len(dkeys) / debit_s:.0f} keys/s ({card}); shortfall on "
          f"{int((short > 0).sum())} keys; the refund in {refund_s:.3f} s; "
          f"both equal to the host float32 oracle")

    _check_native(store)
    # Sweep: past every bucket's time-to-full, every live slot expires.
    live = sum(len(t.dir) for t in store._tables.values())
    clock.advance_seconds(11.0)
    removed_s = [0.0]
    for t in store._tables.values():
        _time_calls(t.dir, "remove_slots", removed_s)
    gc0 = gc_clock.total
    t0 = time.perf_counter()
    store.sweep_all()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_gc_s = gc_clock.total - gc0
    if store.metrics.slots_evicted != live or \
            live != N_KEYS + 2 * n_chunk + len(hot) + 1:
        raise AssertionError(f"sweep evicted {store.metrics.slots_evicted} "
                             f"of {live} live slots")
    print(f"sweep_all: evicted {live} slots in {sweep_s:.3f} s ({card}); "
          f"directory removal {removed_s[0]:.3f} s, garbage collector "
          f"{sweep_gc_s:.3f} s")
    counts = dict(ck.launches)
    gc.callbacks.remove(gc_clock)
    await store.aclose()
    return counts


class _CounterOracle:
    """Host float32 model of the counter table, indexed by key rank: each
    operation of the decay rounded on its own, in the kernel's order."""

    def __init__(self, n: int) -> None:
        self.value = np.zeros(n, np.float32)
        self.period = np.zeros(n, np.float32)
        self.last = np.zeros(n, np.int64)
        self.exists = np.zeros(n, bool)
        self.rate = np.float32(DECAY_PER_S / 1024)

    def decay(self, idx: np.ndarray, now: int):
        ex = self.exists[idx]
        delta = np.maximum(0, now - np.where(ex, self.last[idx], 0)).astype(
            np.float32)
        decayed = np.where(ex, np.maximum(np.float32(0), self.value[idx]
                                          - delta * self.rate),
                           np.float32(0)).astype(np.float32)
        period = np.where(ex, np.float32(0.8) * self.period[idx]
                          + np.float32(0.2) * delta, delta).astype(np.float32)
        return decayed, period

    def sync(self, idx: np.ndarray, counts: np.ndarray, now: int):
        """Rows may repeat: every row sees the pre-sync state, the adds
        accumulate. Returns the replies (decayed + own count, period)."""
        decayed, period = self.decay(idx, now)
        self.value[idx] = decayed
        self.period[idx] = period
        self.last[idx] = now
        self.exists[idx] = True
        np.add.at(self.value, idx, counts)
        return decayed + counts, period


def _check_replies(what, got, want) -> float:
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    if not err <= ATOL:
        raise AssertionError(f"{what}: max abs error {err} > {ATOL}")
    return err


async def approximate_path(torch, ck, pkg, card: str) -> dict:
    """BASELINE config 3, the approximate token bucket at 1M keys with
    Zipf(1.1) skew, on a store of its own; returns the kernel launches it
    made."""
    rng = np.random.default_rng(SEED + 3)
    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", counter_slots=COUNTER_SLOTS,
                                  clock=clock)
    await store.connect()
    _check_native(store)
    keys = [f"tenant:{i}" for i in range(N_COUNTER_KEYS)]
    oracle = _CounterOracle(N_COUNTER_KEYS)
    ck.reset_launches()

    # 1. One fleet sync of 1M distinct counters: one launch. Host split:
    # native resolve, launch (wrapper call), pack + upload (the rest of the
    # dispatch), readback (the rest of the call: device time, copy, await).
    resolve_s, launch_s, dispatch_s = [0.0], [0.0], [0.0]
    _time_calls(store._counter_dir, "resolve_batch", resolve_s)
    _time_calls(store, "_sync_dispatch_many", dispatch_s)
    sync_fn = ck.sync_counters
    _time_calls(ck, "sync_counters", launch_s)
    counts = rng.uniform(0, 100, N_COUNTER_KEYS).astype(np.float32)
    t0 = time.perf_counter()
    scores, periods = await store.sync_counters_many(keys, counts,
                                                     DECAY_PER_S)
    fleet_s = time.perf_counter() - t0
    ck.sync_counters = sync_fn
    if ck.launches["sync_counters"] != 1:
        raise AssertionError(f"fleet sync: {ck.launches['sync_counters']} "
                             "launches, not one")
    want, want_p = oracle.sync(np.arange(N_COUNTER_KEYS), counts,
                               clock.now_ticks())
    if not (np.array_equal(scores, counts) and np.array_equal(scores, want)
            and np.array_equal(periods, want_p)):
        raise AssertionError("fleet sync: a score differs from its count")
    pack_s = dispatch_s[0] - resolve_s[0] - launch_s[0]
    print(f"fleet sync_counters_many: {N_COUNTER_KEYS} counters in "
          f"{fleet_s:.4f} s = {N_COUNTER_KEYS / fleet_s:.0f} counters/s "
          f"({card}); native resolve {resolve_s[0]:.4f} s, pack + upload "
          f"{pack_s:.4f} s, launch {launch_s[0]:.4f} s, readback "
          f"{fleet_s - dispatch_s[0]:.4f} s; every score equals its count")

    # 2. Zipf(1.1) rounds, pre-aggregated per key with np.unique.
    err, n_rows, rounds_s = 0.0, 0, 0.0
    for _ in range(COUNTER_ROUNDS):
        clock.advance_seconds(0.25)
        ranks = (rng.zipf(ZIPF_S, ROUND_DRAWS) - 1) % N_COUNTER_KEYS
        uniq, inv = np.unique(ranks, return_inverse=True)
        agg = np.bincount(inv, weights=rng.uniform(0, 4, ROUND_DRAWS)).astype(
            np.float32)
        batch = [keys[i] for i in uniq]
        t0 = time.perf_counter()
        scores, periods = await store.sync_counters_many(batch, agg,
                                                         DECAY_PER_S)
        rounds_s += time.perf_counter() - t0
        want, want_p = oracle.sync(uniq, agg, clock.now_ticks())
        err = max(err, _check_replies("Zipf round scores", scores, want),
                  _check_replies("Zipf round periods", periods, want_p))
        n_rows += len(uniq)
    print(f"{COUNTER_ROUNDS} Zipf({ZIPF_S}) rounds of {ROUND_DRAWS} draws "
          f"({n_rows} aggregated rows) in {rounds_s:.4f} s = "
          f"{n_rows / rounds_s:.0f} counters/s; replies within {err:.3g} of "
          f"the host oracle")

    # 3. One round left unaggregated: duplicates share the decayed value,
    # each reply adds its own count, the adds accumulate.
    clock.advance_seconds(0.25)
    ranks = (rng.zipf(ZIPF_S, ROUND_DRAWS) - 1) % N_COUNTER_KEYS
    raw = rng.uniform(0, 4, ROUND_DRAWS).astype(np.float32)
    scores, periods = await store.sync_counters_many(
        [keys[i] for i in ranks], raw, DECAY_PER_S)
    want, want_p = oracle.sync(ranks, raw, clock.now_ticks())
    dup_err = max(_check_replies("duplicate round scores", scores, want),
                  _check_replies("duplicate round periods", periods, want_p))
    uniq, inv, reps = np.unique(ranks, return_inverse=True,
                                return_counts=True)
    slots = store._counter_dir.resolve_batch([keys[i] for i in uniq])
    value = store._counters.value[torch.from_numpy(slots).long().to(
        store.device)].cpu().numpy()
    value_err, value_tol = _check_repeated_adds(
        "duplicate round values", inv, value, oracle.value[uniq])
    print(f"unaggregated round: {ROUND_DRAWS} rows on {len(uniq)} keys "
          f"(hottest {reps.max()} times): replies within {dup_err:.3g}, "
          f"values within their per-key limits, largest error {value_err!r} "
          f"(that key's limit {value_tol!r})")

    # 4. Eight approximate limiters sharing one counter, syncing at a
    # staggered cadence.
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        overadmit_epsilon,
    )

    n_lim, limit, rate = 8, 100, 10
    opts = pkg.ApproximateTokenBucketOptions(
        token_limit=limit, tokens_per_period=rate, replenishment_period_s=1.0,
        instance_name="fleet-limiter")
    lims = [pkg.ApproximateTokenBucketRateLimiter(opts, store)
            for _ in range(n_lim)]
    # The counter is fresh, so its first interval is the whole epoch (~1e6
    # ticks); ten rounds (80 syncs, each keeping 0.8 of the EWMA) bring the
    # average down to the 128-tick cadence.
    for _ in range(10):
        for lim in lims:
            clock.advance_seconds(1.0 / n_lim)
            await lim.refresh()
    estimates = [lim._instance_count for lim in lims]
    if estimates != [n_lim] * n_lim:
        raise AssertionError(f"instance estimates {estimates}, not 8")
    per_period = []
    for _ in range(12):
        grants = 0
        for lim in lims:
            while lim.acquire(1).is_acquired:
                grants += 1
            clock.advance_seconds(1.0 / n_lim)
            await lim.refresh()
        per_period.append(grants)
    bound = limit + overadmit_epsilon(0.0, rate, 1.0)
    if max(per_period) > bound:
        raise AssertionError(f"grants per period {per_period} > {bound}")
    for lim in lims:
        await lim.aclose()
    print(f"8 approximate limiters on one counter: instance estimates "
          f"{estimates}; grants per period {per_period} (bound {bound:g})")

    # 5. A day later every counter has expired: sweep_all evicts them all.
    live = len(store._counter_dir)
    clock.advance_seconds(86_401)
    removed_s = [0.0]
    _time_calls(store._counter_dir, "remove_slots", removed_s)
    evicted0 = store.metrics.slots_evicted
    t0 = time.perf_counter()
    store.sweep_all()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    if evicted != live or len(store._counter_dir) != 0 or \
            live != N_COUNTER_KEYS + 1:
        raise AssertionError(f"counter sweep evicted {evicted} of {live}")
    print(f"counter sweep_all: evicted {live} counters in {sweep_s:.4f} s; "
          f"directory removal {removed_s[0]:.4f} s")
    counts = dict(ck.launches)
    await store.aclose()
    return counts


class _WindowOracle:
    """Host float32 serial model of the sliding-window rule, per key, for
    one-permit asks: each ask is granted iff ``(est + granted so far) + 1 <=
    limit``, ``est = curr + prev * (1 - frac)``, every operation rounded in
    float32 (with whole counts and a window of 1024 ticks every value here
    is exact)."""

    def __init__(self, limit: float, window_ticks: int) -> None:
        self.limit = np.float32(limit)
        self.wt = window_ticks
        self.state: dict = {}  # key -> [prev, curr, idx]

    def decide(self, key, n: int, now: int) -> int:
        idx_now = now // self.wt
        prev, curr, idx = self.state.get(key, (0.0, 0.0, idx_now))
        idx_now = max(idx_now, idx)
        steps = idx_now - idx
        prev, curr = ((prev, curr) if steps == 0 else
                      (curr, 0.0) if steps == 1 else (0.0, 0.0))
        prev, curr = np.float32(prev), np.float32(curr)
        frac = np.float32(min(max(np.float32(now - idx_now * self.wt)
                                  / np.float32(self.wt), 0.0), 1.0))
        est = np.float32(curr + np.float32(prev * np.float32(1 - frac)))
        granted = 0
        while granted < n and np.float32(
                np.float32(est + np.float32(granted)) + 1) <= self.limit:
            granted += 1
        self.state[key] = (prev, np.float32(curr + granted), idx_now)
        return granted


async def window_path(torch, ck, pkg, card: str,
                      freeze_gc: bool = False) -> dict:
    """BASELINE config 4, the sliding-window counter at 10M keys with bursty
    Poisson arrivals, on a store of its own (2^24 window slots, ~218 MB);
    returns the kernel launches it made. ``freeze_gc``: move every object
    alive before the arrivals into the collector's permanent generation
    (``gc.freeze()``), so that its passes walk only what the arrivals
    make."""
    from distributedratelimiting.redis_tpu_torch.utils.tracing import (
        ProfilingSession,
    )

    rng = np.random.default_rng(SEED + 4)
    clock = pkg.ManualClock(1_000_000)
    session = ProfilingSession()
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  max_batch=BATCH, clock=clock,
                                  profiling_session=lambda: session)
    opts = pkg.SlidingWindowOptions(permit_limit=WINDOW_LIMIT, window_s=1.0,
                                    instance_name="win")
    lim = pkg.PartitionedWindowRateLimiter(opts, store)
    await store.connect()
    table = store._wtable(opts.permit_limit, opts.window_s)
    resolve_s = [0.0]
    _time_calls(table.dir, "resolve_batch", resolve_s)
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    ck.reset_launches()

    # 1. Bulk: 10M distinct keys, one permit each, then 1M again.
    t0 = time.perf_counter()
    res = await lim.acquire_many(range(N_KEYS), permits=1,
                                 with_remaining=False)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    if len(res) != N_KEYS or res.granted_count != N_KEYS:
        raise AssertionError(f"window bulk: {res.granted_count}/{len(res)} "
                             "granted")
    dispatch_s = sum(c.duration_s for c in session.finish())
    bulk_launches = ck.launches["window_scan"]
    res = await lim.acquire_many(range(0, N_KEYS, 10), permits=1)
    if not (res.granted.all() and np.all(res.remaining == WINDOW_LIMIT - 2)):
        raise AssertionError("window bulk: second call's remaining is not "
                             f"{WINDOW_LIMIT - 2}")
    print(f"window bulk acquire_many: {N_KEYS} distinct keys in "
          f"{bulk_s:.3f} s = {N_KEYS / bulk_s:.0f} decisions/s ({card}); "
          f"host dispatch {dispatch_s:.3f} s, of which key->slot resolve "
          f"{resolve_s[0]:.3f} s; garbage collector {gc_clock.total:.3f} s; "
          f"{bulk_launches} window_scan launches")

    # 2. Bursty Poisson arrivals through acquire_async, against the oracle.
    oracle = _WindowOracle(WINDOW_LIMIT, WINDOW_TICKS)
    idx0 = clock.now_ticks() // WINDOW_TICKS
    hot = rng.choice(N_KEYS, N_HOT, replace=False)
    bursts = set(rng.choice(WINDOW_STEPS,
                            round(WINDOW_BURST_SHARE * WINDOW_STEPS),
                            replace=False).tolist())
    store.metrics.flush_latency.reset()
    session.finish()
    gc0 = gc_clock.total
    gc_clock.longest = 0.0
    tracked = len(gc.get_objects())  # what a full collection walks
    if freeze_gc:
        gc.freeze()
    passes0 = list(gc_clock.passes)
    n_req = n_granted = 0
    wall = 0.0
    for step in range(WINDOW_STEPS):
        burst = step in bursts
        m = int(rng.poisson(WINDOW_BASE_ARRIVALS * (10 if burst else 1)))
        keys = rng.integers(0, N_KEYS, m)
        if burst:
            h = rng.random(m) < HOT_SHARE
            keys[h] = hot[rng.integers(0, N_HOT, int(h.sum()))]
        now = clock.now_ticks()
        t0 = time.perf_counter()
        leases = await asyncio.gather(*(lim.acquire_async(int(k))
                                        for k in keys))
        wall += time.perf_counter() - t0
        uniq, inv = np.unique(keys, return_inverse=True)
        got = np.bincount(inv, weights=[bool(x) for x in leases],
                          minlength=len(uniq)).astype(np.int64)
        asks = np.bincount(inv, minlength=len(uniq))
        for u, a, g in zip(uniq.tolist(), asks.tolist(), got.tolist()):
            if int(u) not in oracle.state:  # the bulk's counts, window idx0
                oracle.state[int(u)] = (0.0, 2.0 if u % 10 == 0 else 1.0,
                                        idx0)
            want = oracle.decide(int(u), a, now)
            if g != want:
                raise AssertionError(f"window key {u} at tick {now}: "
                                     f"{g} of {a} granted, oracle {want}")
        n_req += m
        n_granted += int(got.sum())
        clock.advance_ticks(WINDOW_STEP_TICKS)
    flushes = store.metrics.flush_latency.total
    dispatch_s = sum(c.duration_s for c in session.finish())
    print(f"window acquire_async, {WINDOW_STEPS} steps of "
          f"{WINDOW_STEP_TICKS} ticks ({len(bursts)} bursts at 10x): "
          f"{n_req} "
          f"requests in {wall:.3f} s = {n_req / wall:.0f} decisions/s "
          f"({card}); {n_granted} granted, every key's grants equal to the "
          f"host float32 oracle; {flushes} flushes, host dispatch "
          f"{dispatch_s:.3f} s, flush p50 "
          f"{store.metrics.flush_latency.p50 * 1e3:.3f} ms, p99 "
          f"{store.metrics.flush_latency.p99 * 1e3:.3f} ms, garbage "
          f"collector {gc_clock.total - gc0:.3f} s (longest pause "
          f"{gc_clock.longest:.3f} s; passes by generation "
          f"{[a - b for a, b in zip(gc_clock.passes, passes0)]}; {tracked} "
          f"objects tracked at the start"
          f"{', frozen' if freeze_gc else ''})")
    if freeze_gc:
        gc.unfreeze()
    if not 0 < n_granted < n_req:
        raise AssertionError("window traffic: no mix of grants and denials")

    # 3. Cap-5 x 32 inside one window -> 5; readmission after roll-off
    # (sliding: two windows, once the previous count has slid out; fixed:
    # the next window).
    for fixed in (False, True):
        o = (pkg.FixedWindowOptions if fixed else pkg.SlidingWindowOptions)(
            permit_limit=5, window_s=1.0,
            instance_name="fcap5" if fixed else "cap5")
        cap5 = pkg.PartitionedWindowRateLimiter(o, store)
        for _ in range(2):
            five = await asyncio.gather(*(cap5.acquire_async("h5")
                                          for _ in range(32)))
            if sum(map(bool, five)) != 5:
                raise AssertionError(f"window cap-5 (fixed={fixed}) granted "
                                     f"{sum(map(bool, five))}")
            clock.advance_ticks(WINDOW_TICKS * (1 if fixed else 2))
    print("window cap-5 x 32 asks: 5 granted, and 5 again after roll-off, "
          "sliding and fixed")

    # 4. Two windows after the last touch every slot expires.
    _check_native(store)
    live = sum(len(t.dir) for t in store._wtables.values())
    if live != N_KEYS + 2:
        raise AssertionError(f"window tables hold {live} keys")
    clock.advance_ticks(3 * WINDOW_TICKS)
    removed_s = [0.0]
    for t in store._wtables.values():
        _time_calls(t.dir, "remove_slots", removed_s)
    evicted0 = store.metrics.slots_evicted
    t0 = time.perf_counter()
    store.sweep_all()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    if evicted != live:
        raise AssertionError(f"window sweep evicted {evicted} of {live}")
    print(f"window sweep_all: evicted exactly {live} slots in {sweep_s:.3f} "
          f"s; directory removal {removed_s[0]:.3f} s")
    counts = dict(ck.launches)
    gc.callbacks.remove(gc_clock)
    await store.aclose()
    return counts


async def _raw_request(addr, frame: bytes):
    """One frame on a connection of its own; the decoded reply."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    reader, writer = await asyncio.open_connection(*addr)
    try:
        writer.write(frame)
        await writer.drain()
        body = await asyncio.wait_for(wire.read_frame(reader), 30)
        return wire.decode_response(body)
    finally:
        writer.close()


#: Wall seconds of the in-process main path's key→slot resolve (strings),
#: set by ``main_path`` and printed beside the server's key-blob resolve.
_INPROCESS_RESOLVE_S = [0.0]
#: Extra arguments for the console server (the CPU rehearsal adds
#: ``--device cpu``; on the card it runs with none, so on ``cuda``).
CLI_EXTRA_ARGS: list = []


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


async def _scalar_round(lim, keys, order, workers):
    """One round of ``acquire_async``: ``workers`` tasks take the keys in
    ``order``; returns per-key grants and per-request latencies (s)."""
    it = iter(order)
    grants = np.zeros(len(keys), np.int64)
    lat = []

    async def worker():
        for i in it:
            t = time.perf_counter()
            lease = await lim.acquire_async(keys[i])
            lat.append(time.perf_counter() - t)
            grants[i] += bool(lease)

    await asyncio.gather(*(worker() for _ in range(workers)))
    return grants, lat


async def scalar_client(pkg, addr, n_keys: int) -> dict:
    """The server path's scalar phase, run in a process of its own as a
    client host would: ``acquire_async`` through ``PartitionedRateLimiter``
    over ``RemoteBucketStore``s, 64 tasks, ``n_keys`` uniform keys, token
    limit 5, 10 asks per key on the server's unadvanced clock. Rounds
    alternate between a coalescing client (ACQUIRE_MANY flushes →
    acquire_scan) and a per-request one (OP_ACQUIRE → acquire_packed); the
    first 5 rounds must grant every ask and the last 5 deny every ask, so
    each key grants min(5, 10) = 5. Returns the grants, and per client the
    rate, the latencies and the frames it sent."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    frames = [0]
    write_frame = wire.write_frame

    def counted(writer, data):
        frames[0] += 1
        write_frame(writer, data)

    wire.write_frame = counted
    opts = pkg.TokenBucketOptions(token_limit=SCALAR_LIMIT,
                                  tokens_per_period=1,
                                  replenishment_period_s=1.0,
                                  instance_name="scalar")
    stores = {lane: pkg.RemoteBucketStore(
        address=addr, coalesce_requests=lane == "coalesced")
        for lane in SCALAR_LANES}
    lims = {lane: pkg.PartitionedRateLimiter(opts, st)
            for lane, st in stores.items()}
    keys = list(range(n_keys))
    rng = np.random.default_rng(SEED + 2)
    total = np.zeros(n_keys, np.int64)
    clients = {lane: {"requests": 0, "wall_s": 0.0, "frames": 0, "lat": []}
               for lane in SCALAR_LANES}
    rounds = []
    for r in range(SCALAR_ASKS):
        lane = SCALAR_LANES[r % 2]
        c = clients[lane]
        f0 = frames[0]
        t0 = time.perf_counter()
        grants, lat = await _scalar_round(lims[lane], keys,
                                          rng.permutation(n_keys),
                                          SCALAR_TASKS)
        c["wall_s"] += time.perf_counter() - t0
        c["frames"] += frames[0] - f0
        c["requests"] += n_keys
        c["lat"] += lat
        rounds.append((lane, np.unique(grants).tolist()))
        total += grants
    for st in stores.values():
        await st.aclose()
    for c in clients.values():
        lat = c.pop("lat")
        c["p50_ms"], c["p99_ms"] = _pct(lat, 50) * 1e3, _pct(lat, 99) * 1e3
    return {"rounds": rounds, "totals": np.unique(total).tolist(),
            "clients": clients}


async def server_path(torch, ck, pkg, card: str) -> dict:
    """The shared store server (README "Multi-host"; BASELINE config 2's
    shape): a ``BucketStoreServer`` over a ``DeviceBucketStore`` on the card
    at the main path's size, limiters on ``RemoteBucketStore`` clients.
    Returns the kernel launches the path made."""
    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  counter_slots=COUNTER_SLOTS,
                                  max_batch=BATCH, clock=clock)
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0)
    host, port = await server.start()
    addr = (host, port)
    opts = pkg.TokenBucketOptions(token_limit=100, tokens_per_period=10,
                                  replenishment_period_s=1.0,
                                  instance_name="wire")
    # The table exists before the timing, so its key-blob resolve is timed.
    table = store._table(opts.token_limit, opts.fill_rate_per_second)
    resolve_s = [0.0]
    _time_calls(table.dir, "resolve_batch", resolve_s)
    bulk_cli = pkg.RemoteBucketStore(address=addr, request_timeout_s=600.0)
    co = pkg.RemoteBucketStore(address=addr, clock=clock)
    solo = pkg.RemoteBucketStore(address=addr, clock=clock,
                                 coalesce_requests=False)
    ck.reset_launches()

    # 1. Bulk over the wire: 10M distinct keys as ACQUIRE_MANY frames
    # (chained chunks under MAX_FRAME), resolved from each frame's bytes.
    lim = pkg.PartitionedRateLimiter(opts, bulk_cli)
    frames0 = server.requests_served
    t0 = time.perf_counter()
    res = await lim.acquire_many(range(N_KEYS), permits=1,
                                 with_remaining=False)
    bulk_s = time.perf_counter() - t0
    frames = server.requests_served - frames0
    if len(res) != N_KEYS or res.granted_count != N_KEYS:
        raise AssertionError(f"wire bulk: {res.granted_count}/{len(res)} "
                             "granted")
    sub = range(0, N_KEYS, 10)
    res = await lim.acquire_many(sub, permits=1)
    if not (res.granted.all() and np.all(res.remaining == 98.0)):
        raise AssertionError("wire bulk: second call's remaining is not 98")
    print(f"server bulk acquire_many over the wire: {N_KEYS} distinct keys "
          f"in {bulk_s:.3f} s = {N_KEYS / bulk_s:.0f} decisions/s ({card}); "
          f"{frames} ACQUIRE_MANY frames; server key-blob resolve "
          f"{resolve_s[0]:.3f} s for {N_KEYS + len(sub)} keys (in-process "
          f"path's string resolve {_INPROCESS_RESOLVE_S[0]:.3f} s for "
          f"{N_KEYS}); every grant and remaining checked")

    # 2. Scalar acquire_async, BASELINE config 2's shape, from a client
    # process of its own (a client host; see scalar_client).
    await co.stats(reset=True)
    frames0 = server.requests_served
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), "--scalar-client", host,
        str(port), str(N_SCALAR_KEYS), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 900)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    phase_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"scalar client exited {proc.returncode}: "
                             f"{err.decode()[-3000:]}")
    rep = json.loads(out.decode().strip().splitlines()[-1])
    for r, (lane, values) in enumerate(rep["rounds"]):
        want = 1 if r < SCALAR_LIMIT else 0
        if values != [want]:
            raise AssertionError(f"scalar round {r} ({lane}): grants per "
                                 f"key {values}, not all {want}")
    if rep["totals"] != [min(SCALAR_LIMIT, SCALAR_ASKS)]:
        raise AssertionError(f"scalar grants per key {rep['totals']} differ "
                             "from min(limit, asks)")
    stats = await co.stats()
    for lane, c in rep["clients"].items():
        print(f"server scalar acquire_async ({lane} client, {SCALAR_TASKS} "
              f"tasks): {c['requests']} requests in {c['wall_s']:.3f} s = "
              f"{c['requests'] / c['wall_s']:.0f} requests/s ({card}); "
              f"client p50 {c['p50_ms']:.3f} ms, p99 {c['p99_ms']:.3f} ms; "
              f"{c['frames']} frames sent")
    stages = "; ".join(f"{k} p50 {v['p50_ms']:.3f} ms, p99 "
                       f"{v['p99_ms']:.3f} ms"
                       for k, v in stats.get("stages", {}).items())
    print(f"server scalar: {phase_s:.3f} s with the client process's start; "
          f"grants per key exactly min({SCALAR_LIMIT}, {SCALAR_ASKS}) for "
          f"{N_SCALAR_KEYS} keys "
          f"(every round all granted, then all denied); server (OP_STATS) "
          f"serving p50 {stats['serving_p50_ms']:.3f} ms, p99 "
          f"{stats['serving_p99_ms']:.3f} ms over {stats['serving_samples']} "
          f"frames ({server.requests_served - frames0} served); stages: "
          f"{stages}")
    # Cap-5 × 32 over the wire, on both lanes (duplicates in one flush).
    for name, cli in (("per-request", solo), ("coalesced", co)):
        cap5 = pkg.PartitionedRateLimiter(
            pkg.TokenBucketOptions(token_limit=5, tokens_per_period=1,
                                   instance_name=f"cap5-{name}"), cli)
        five = await asyncio.gather(*(cap5.acquire_async("h5")
                                      for _ in range(32)))
        if sum(map(bool, five)) != 5:
            raise AssertionError(f"cap-5 over the wire ({name}) granted "
                                 f"{sum(map(bool, five))}")
    print("server cap-5 bucket x 32 asks: 5 granted on both lanes")

    # Windows over the wire: window-kind ACQUIRE_MANY frames, then
    # OP_WINDOW / OP_FWINDOW requests (one frame each), on the unadvanced
    # clock: every estimate is a whole number and each key's grants are
    # min(limit, asks).
    wlim = pkg.PartitionedWindowRateLimiter(pkg.SlidingWindowOptions(
        permit_limit=WINDOW_LIMIT, window_s=1.0, instance_name="wire-win"),
        bulk_cli)
    # The server's window tables exist before the timing (each is a 2^24-slot
    # table and directory on first use); their creation is timed apart.
    t0 = time.perf_counter()
    for limit, fixed in ((WINDOW_LIMIT, False), (WIRE_WINDOW_LIMIT, False),
                         (WIRE_WINDOW_LIMIT, True), (5, False), (5, True)):
        store._wtable(limit, 1.0, fixed)
    torch.cuda.synchronize()
    tables_s = (time.perf_counter() - t0) / 5
    frames0 = server.requests_served
    t0 = time.perf_counter()
    res = await wlim.acquire_many(range(N_WIRE_WINDOW_KEYS), permits=1,
                                  with_remaining=False)
    wbulk_s = time.perf_counter() - t0
    wframes = server.requests_served - frames0
    if res.granted_count != N_WIRE_WINDOW_KEYS:
        raise AssertionError(f"wire window bulk: {res.granted_count} granted")
    res = await wlim.acquire_many(range(0, N_WIRE_WINDOW_KEYS, 10),
                                  permits=1)
    if not (res.granted.all()
            and np.all(res.remaining == WINDOW_LIMIT - 2)):
        raise AssertionError("wire window bulk: remaining is not "
                             f"{WINDOW_LIMIT - 2}")
    print(f"server window bulk (BULK_KIND_WINDOW frames): "
          f"{N_WIRE_WINDOW_KEYS} distinct keys in {wbulk_s:.3f} s = "
          f"{N_WIRE_WINDOW_KEYS / wbulk_s:.0f} decisions/s ({card}); "
          f"{wframes} frames; every grant and remaining checked (a window "
          f"table of {N_SLOTS} slots and its directory: {tables_s:.3f} s to "
          f"create, untimed)")
    wkeys = list(range(N_WIRE_SCALAR_WINDOW_KEYS))
    rng = np.random.default_rng(SEED + 5)
    n_wreq, wwall, wlat = 0, 0.0, []
    for fixed in (False, True):
        o = (pkg.FixedWindowOptions if fixed else pkg.SlidingWindowOptions)(
            permit_limit=WIRE_WINDOW_LIMIT, window_s=1.0,
            instance_name="wire-fwin" if fixed else "wire-swin")
        wl = pkg.PartitionedWindowRateLimiter(o, solo)
        total = np.zeros(len(wkeys), np.int64)
        for r in range(WIRE_WINDOW_ASKS):
            t0 = time.perf_counter()
            grants, lat = await _scalar_round(wl, wkeys,
                                              rng.permutation(len(wkeys)),
                                              SCALAR_TASKS)
            wwall += time.perf_counter() - t0
            wlat += lat
            want = 1 if r < WIRE_WINDOW_LIMIT else 0
            if np.unique(grants).tolist() != [want]:
                raise AssertionError(f"wire window round {r} (fixed="
                                     f"{fixed}): grants per key "
                                     f"{np.unique(grants).tolist()}")
            total += grants
            n_wreq += len(wkeys)
        cap5 = pkg.PartitionedWindowRateLimiter(
            (pkg.FixedWindowOptions if fixed else pkg.SlidingWindowOptions)(
                permit_limit=5, window_s=1.0, instance_name=f"wcap5-{fixed}"),
            solo)
        five = await asyncio.gather(*(cap5.acquire_async("h5")
                                      for _ in range(32)))
        if sum(map(bool, five)) != 5:
            raise AssertionError(f"wire window cap-5 (fixed={fixed}) granted "
                                 f"{sum(map(bool, five))}")
    print(f"server OP_WINDOW / OP_FWINDOW: {n_wreq} requests over "
          f"{len(wkeys)} keys in {wwall:.3f} s = {n_wreq / wwall:.0f} "
          f"requests/s ({card}), client p50 {_pct(wlat, 50) * 1e3:.3f} ms, "
          f"p99 {_pct(wlat, 99) * 1e3:.3f} ms; grants per key exactly "
          f"min({WIRE_WINDOW_LIMIT}, {WIRE_WINDOW_ASKS}) (the oracle); cap-5 "
          f"x 32 -> 5, sliding and fixed")
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    _, kind, vals = await _raw_request(addr, wire.encode_request(
        77, wire.OP_CONFIG, "{}", 1, 5.0, 0.0))
    if kind != wire.RESP_TEXT or json.loads(vals[0]) != {"version": 0,
                                                         "rules": []}:
        raise AssertionError(f"OP_CONFIG fetch answered {kind} {vals}")
    print(f"server OP_CONFIG fetch: {vals[0]!r}")
    # OP_RESERVE / OP_SETTLE as raw JSON frames: a hold of 10, settled at
    # 4 (the refund of 6 is one debit launch a level).
    replies = []
    for seq, op, body in (
            (78, wire.OP_RESERVE, {"rid": "raw1", "tenant": "rt", "key": "rk",
                                   "estimate": 10.0, "a": 50.0, "b": 1.0,
                                   "ta": 90.0, "tb": 1.0}),
            (79, wire.OP_SETTLE, {"rid": "raw1", "tenant": "rt",
                                  "actual": 4.0})):
        _, kind, vals = await _raw_request(addr, wire.encode_request(
            seq, op, json.dumps(body), 0, 0.0, 0.0))
        if kind != wire.RESP_TEXT:
            raise AssertionError(f"{wire.op_name(op)} answered {kind} {vals}")
        replies.append(json.loads(vals[0]))
    if not (replies[0]["granted"] and replies[0]["reserved"] == 10.0
            and replies[1] == {"outcome": "settled", "delta": -6.0,
                               "refunded": 6.0, "debt": 0.0}
            and store.peek_blocking("rt", 90.0, 1.0) == 86.0
            and store.peek_blocking("rk", 50.0, 1.0) == 46.0):
        raise AssertionError(f"raw OP_RESERVE / OP_SETTLE: {replies}")
    print(f"server OP_RESERVE / OP_SETTLE frames: {replies[0]}, "
          f"{replies[1]}; both levels hold 4 tokens less")

    # Semaphores over the wire: OP_SEMA frames, rounds of 32 concurrent
    # acquires on a cap-5 key (exactly 5 granted), then the 5 releases.
    t0 = time.perf_counter()
    for r in range(N_WIRE_SEMA_ROUNDS):
        key = f"wsema:{r}"
        got = await asyncio.gather(*(solo.concurrency_acquire(key, 1, 5)
                                     for _ in range(32)))
        if sum(g.granted for g in got) != 5:
            raise AssertionError(f"OP_SEMA cap-5 round {r}: "
                                 f"{sum(g.granted for g in got)} granted")
        await asyncio.gather(*(solo.concurrency_release(key, 1)
                               for _ in range(5)))
    sema_s = time.perf_counter() - t0
    n_sema = N_WIRE_SEMA_ROUNDS * 37
    print(f"server OP_SEMA: {N_WIRE_SEMA_ROUNDS * 32} acquires (cap-5 x 32 "
          f"-> 5 in every round) and {N_WIRE_SEMA_ROUNDS * 5} releases in "
          f"{sema_s:.3f} s = {n_sema / sema_s:.0f} requests/s ({card})")

    # Two-level admission over the wire on the LLM rows, held row by row to
    # the port's CPU store on the same clock schedule: OP_ACQUIRE_H, one
    # frame a request, then the 2^16 rows as HBUCKET frames, one per tenant
    # in each 2,048-row window (benchmarks/llm_workload.py:111-131).
    tenants, hkeys, costs, _ = _llm_workload(LLM_SEED, LLM_ROWS)
    ccap, tcap, rate = LLM_BUDGETS[0], LLM_BINDING_TENANT, LLM_RATE
    oracle = pkg.DeviceBucketStore(device="cpu", n_slots=LLM_SLOTS,
                                   max_batch=BATCH,
                                   clock=pkg.ManualClock(clock.now_ticks()))
    t0 = time.perf_counter()
    got = [(await solo.acquire_hierarchical(
        tenants[i], hkeys[i], int(costs[i]), tcap, rate, ccap,
        rate)).granted for i in range(N_WIRE_HIER)]
    hier_s = time.perf_counter() - t0
    want = [oracle.acquire_hierarchical_blocking(
        tenants[i], hkeys[i], int(costs[i]), tcap, rate, ccap,
        rate).granted for i in range(N_WIRE_HIER)]
    if got != want:
        raise AssertionError("OP_ACQUIRE_H grants differ from the CPU store")
    print(f"server OP_ACQUIRE_H: {N_WIRE_HIER} LLM rows one frame each in "
          f"{hier_s:.3f} s = {N_WIRE_HIER / hier_s:.0f} requests/s ({card}); "
          f"{sum(got)} granted, equal to the CPU store")
    frames0 = server.requests_served
    granted, hb_s = [], 0.0
    for wt, wk, wc in _llm_windows(tenants, hkeys, costs):
        clock.advance_ticks(LLM_STEP_TICKS)
        oracle.clock.advance_ticks(LLM_STEP_TICKS)
        t0 = time.perf_counter()
        r = await bulk_cli.acquire_hierarchical_many(
            wt, wk, wc, tcap, rate, ccap, rate, with_remaining=False)
        hb_s += time.perf_counter() - t0
        o = await oracle.acquire_hierarchical_many(wt, wk, wc, tcap, rate,
                                                   ccap, rate)
        if r.granted.tolist() != o.granted.tolist():
            raise AssertionError("HBUCKET grants differ from the CPU store")
        granted.append(r.granted)
    granted = np.concatenate(granted)
    hframes = server.requests_served - frames0
    await oracle.aclose()
    print(f"server HBUCKET bulk: {LLM_ROWS} LLM rows as {hframes} frames "
          f"(one per tenant per {LLM_WINDOW}-row window) in {hb_s:.3f} s = "
          f"{LLM_ROWS / hb_s:.0f} rows/s, {int(costs.sum()) / hb_s:.0f} "
          f"tokens/s offered ({card}); {granted.sum()} granted "
          f"({1 - granted.mean():.1%} denied), equal to the CPU store")
    stats = await solo.stats()
    if not stats.get("token_velocity", {}).get("observed_tokens"):
        raise AssertionError("OP_STATS has no token_velocity")

    # 3. Counter syncs: eight approximate limiters on one key over one
    # remote store, held to the approximate path's bound.
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        overadmit_epsilon,
    )

    n_lim, limit, rate = 8, 100, 10
    aopts = pkg.ApproximateTokenBucketOptions(
        token_limit=limit, tokens_per_period=rate, replenishment_period_s=1.0,
        instance_name="wire-fleet")
    alims = [pkg.ApproximateTokenBucketRateLimiter(aopts, solo)
             for _ in range(n_lim)]
    for _ in range(10):
        for a in alims:
            clock.advance_seconds(1.0 / n_lim)
            await a.refresh()
    estimates = [a._instance_count for a in alims]
    if estimates != [n_lim] * n_lim:
        raise AssertionError(f"wire instance estimates {estimates}, not 8")
    per_period = []
    for _ in range(12):
        grants = 0
        for a in alims:
            while a.acquire(1).is_acquired:
                grants += 1
            clock.advance_seconds(1.0 / n_lim)
            await a.refresh()
        per_period.append(grants)
    bound = limit + overadmit_epsilon(0.0, rate, 1.0)
    if max(per_period) > bound:
        raise AssertionError(f"wire grants per period {per_period} > "
                             f"{bound}")
    for a in alims:
        await a.aclose()
    print(f"server OP_SYNC: 8 approximate limiters on one counter, instance "
          f"estimates {estimates}; grants per period {per_period} (bound "
          f"{bound:g})")

    # 4. The periodic sweeper: a day later every bucket, window, the counter
    # and every (zero-held) semaphore have expired; the sweeper (every 0.5
    # s) evicts exactly them.
    _check_native(store)
    live = sum(len(t.dir) for t in store._tables.values())
    # The last 2: the raw reserve's tenant and key.
    want_live = (N_KEYS + N_SCALAR_KEYS + 2 + len(set(hkeys))
                 + len(set(tenants)) + 2)
    if live != want_live:
        raise AssertionError(f"server holds {live} buckets, not {want_live}")
    wlive = sum(len(t.dir) for t in store._wtables.values())
    want_wlive = N_WIRE_WINDOW_KEYS + 2 * N_WIRE_SCALAR_WINDOW_KEYS + 2
    if wlive != want_wlive:
        raise AssertionError(f"server holds {wlive} windows, not "
                             f"{want_wlive}")
    if len(store._sema_dir) != N_WIRE_SEMA_ROUNDS:
        raise AssertionError(f"server holds {len(store._sema_dir)} "
                             "semaphores")
    live += wlive + len(store._counter_dir) + len(store._sema_dir)
    evicted0 = store.metrics.slots_evicted
    store.start_sweeper(0.5)
    clock.advance_seconds(86_401)
    t0 = time.perf_counter()
    while (store.metrics.slots_evicted - evicted0 < live
           and time.perf_counter() - t0 < 120):
        await asyncio.sleep(0.05)
    waited = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    left = sum(len(t.dir) for t in (*store._tables.values(),
                                    *store._wtables.values())) + len(
        store._counter_dir) + len(store._sema_dir)
    if evicted != live or left:
        raise AssertionError(f"sweeper evicted {evicted} of {live} ({left} "
                             "left)")
    print(f"server periodic sweeper (0.5 s): evicted exactly {live} slots "
          f"({wlive} of them windows, {N_WIRE_SEMA_ROUNDS} semaphores) within "
          f"{waited:.3f} s of the clock passing their TTL")
    for cli in (bulk_cli, co, solo):
        await cli.aclose()
    await server.aclose()
    await store.aclose()
    if store._sweeper_task is not None:
        raise AssertionError("aclose left the sweeper running")
    counts = dict(ck.launches)
    print(f"server path kernel launches: {counts}")
    return counts


def cli_server(pkg, *flags) -> None:
    """The console entry point on the card: start it (no ``--device``, so
    ``cuda``; ``flags`` added, the fp path's ``--directory fp``), read its
    listening line, ping, cap-5 × 32 → 5 for a bucket and for a window,
    check that ``OP_STATS`` has the JAX server's keys, SIGTERM → exit 0."""
    import select
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m",
           "distributedratelimiting.redis_tpu_torch.runtime.server",
           "--port", "0", "--slots", "1048576", "--sweep-period", "1",
           *flags, *CLI_EXTRA_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        line = proc.stdout.readline() if ready else ""
        prefix = "bucket-store server listening on "
        if not line.startswith(prefix):
            proc.kill()
            raise AssertionError(f"console server printed {line!r}; stderr "
                                 f"{proc.communicate()[1][-2000:]!r}")
        start_s = time.perf_counter() - t0
        host, port = line[len(prefix):].strip().rsplit(":", 1)

        async def drive():
            cli = pkg.RemoteBucketStore(address=(host, int(port)))
            await cli.ping()
            res = await asyncio.gather(*(cli.acquire("five", 1, 5.0, 1.0)
                                         for _ in range(32)))
            win = await asyncio.gather(*(cli.window_acquire("wfive", 1, 5.0,
                                                            60.0)
                                         for _ in range(32)))
            stats = await cli.stats()
            await cli.aclose()
            return (sum(r.granted for r in res), sum(r.granted for r in win),
                    stats)

        granted, wgranted, stats = asyncio.run(drive())
        if (granted, wgranted) != (5, 5):
            raise AssertionError(f"console server: cap-5 granted {granted} "
                                 f"(bucket), {wgranted} (window)")
        keys = {"connections_served", "requests_served", "serving_p50_ms",
                "serving_p99_ms", "serving_samples", "requests_shed",
                "stats_resets", "store"}
        if not keys <= set(stats):
            raise AssertionError(f"console server OP_STATS lacks "
                                 f"{keys - set(stats)}")
        if not {"pregrows", "fp_unresolved"} <= set(stats["store"]):
            raise AssertionError("console server OP_STATS' store lacks "
                                 "pregrows / fp_unresolved")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        if rc != 0:
            raise AssertionError(f"console server exited {rc} on SIGTERM")
        print(f"console server ({' '.join(cmd[2:])}): listening after "
              f"{start_s:.1f} s, ping, cap-5 x 32 -> 5 (bucket and window), "
              "OP_STATS keys "
              f"present, SIGTERM -> exit 0 in {time.perf_counter() - t1:.2f} "
              "s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _llm_workload(seed: int, n_rows: int):
    """The LLM workload's generator, copied from
    ``benchmarks/llm_workload.py:63-91`` (``gen_workload``; the script
    imports nothing of the benchmarks): 64 tenants Zipf(1.2), keys
    ``t{t}/u{zipf(1.5) % 200}``, costs LogNormal(4.0, 1.3) clamped to [1,
    8192], priorities 60/30/10 interactive / batch / scavenger. Returns
    ``(tenants, keys, costs i64[n], priorities i8[n])``."""
    rng = np.random.default_rng(seed)
    t_idx = rng.zipf(1.2, n_rows) % 64
    costs = np.minimum(np.maximum(rng.lognormal(4.0, 1.3, n_rows), 1.0),
                       8192).astype(np.int64)
    u = rng.random(n_rows)
    prios = np.where(u < 0.6, 0, np.where(u < 0.9, 1, 2)).astype(np.int8)
    keys = [f"t{t}/u{rng.zipf(1.5) % 200}" for t in t_idx]
    tenants = [f"tenant:{t}" for t in t_idx]
    return tenants, keys, costs, prios


def _dense_ids(names) -> np.ndarray:
    """Each name's rank of first appearance, as int32 slot ids."""
    ids: dict = {}
    return np.array([ids.setdefault(n, len(ids)) for n in names], np.int32)


def _hier_levels(torch, K, bm, child, parent, packed, ccap, crate, pcap,
                 prate):
    """The two-level rule's pieces as the plain version computes them, on
    the tables before a launch: ``(child_ok, granted, near)``, ``near``
    marking rows whose margin ``ref - (prefix + cost)`` at either level
    lies within two float32 spacings of 0 (a rounding could flip them)."""
    cs, cnt, now, ps = packed[0], packed[1], int(packed[2, 0]), packed[3]
    valid = ((cs >= 0) & (cs < child.tokens.shape[0]) & (ps >= 0)
             & (ps < parent.tokens.shape[0]))
    cf = cnt.to(torch.float32)
    c_ref = bm.refill_or_init(*K._gather(child, cs, valid), now, ccap, crate)
    p_ref = bm.refill_or_init(*K._gather(parent, ps, valid), now, pcap, prate)
    c_need = bm.duplicate_prefix(cs, cnt, valid) + cf
    child_ok = valid & (c_ref >= c_need)
    p_need = bm.duplicate_prefix(ps, torch.where(child_ok, cnt,
                                                 torch.zeros_like(cnt)),
                                 valid) + cf
    granted = child_ok & (p_ref >= p_need)

    def close(ref, need):
        mag = torch.maximum(ref.abs(), need.abs()).cpu().numpy()
        gap = (ref - need).abs().cpu().numpy()
        return torch.from_numpy(gap <= 2 * np.spacing(mag)).to(ref.device)

    near = valid & (close(c_ref, c_need) | (child_ok & close(p_ref, p_need)))
    return child_ok, granted, near


def admission_cases(torch, K, ck, dev, rng) -> dict:
    """The semaphore, two-level admission and debit kernels against their
    plain versions on the card, at the admission path's shapes."""
    from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm

    res = {}
    # -- sema_packed at B = 8 and B = 4096 over a 2^20 table ----------------
    n, now = SEMA_SLOTS, 3_000_000
    table = (torch.tensor(rng.integers(0, 6, n).astype(np.int32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                          device=dev),
             torch.tensor(rng.random(n) < 0.6, device=dev))
    sema = {}
    for b in (8, BATCH):
        slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
        slots[: b // 4] = slots[b // 4]  # repeats, also at B = 8
        slots[rng.permutation(b)[: max(1, b // 32)]] = -1
        slots[rng.permutation(b)[: max(1, b // 64)]] = n + 7
        deltas = rng.integers(-2, 4, b).astype(np.int32)
        deltas[:3] = (1, -1, 0)  # an acquire, a release and a probe
        limits = rng.integers(0, 9, b).astype(np.int32)
        packed = np.stack([slots, deltas, limits, np.full(b, now, np.int32)])
        op = torch.from_numpy(packed).to(dev)
        ks = K.SemaState(*(x.clone() for x in table))
        ps = K.SemaState(*(x.clone() for x in table))
        got = ck.sema_packed(ks, op)
        _, want = K.sema_batch_packed(ps, op)
        torch.cuda.synchronize()
        _check_equal(f"sema_packed B={b} replies", got, want)
        for name in ("active", "last_ts", "exists"):
            _check_equal(f"sema_packed B={b} {name}", getattr(ks, name),
                         getattr(ps, name))
        ok = want[0].cpu().numpy()
        if not 0 < ok.sum() < b:
            raise AssertionError(f"sema_packed B={b}: not a mix of grants")
        ms = _median_ms(lambda: ck.sema_packed(ks, op), inner=20)
        plain_ms = _median_ms(lambda: K.sema_batch_packed(ps, op), reps=5,
                              warmup=1)
        dev_ms = _device_ms(lambda: ck.sema_packed(ks, op), SEMA_KERNELS)
        distinct = len(np.unique(slots[(slots >= 0) & (slots < n)]))
        # Bytes: the 16 B operand row and 8 B reply, 9 B of state read and
        # written per distinct slot. ~12 operations a row.
        sema[b] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bytes=24 * b + 18 * distinct,
                       ops=12 * b, device_ms=dev_ms)
        print(f"sema_packed B={b} ({distinct} distinct slots, repeats, "
              f"releases, probes, padding) over {n} slots: replies and "
              f"every state field equal to plain; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, device time {dev_ms} ms)")
    res["sema_packed"] = sema[BATCH]

    # -- sweep_semas over 2^20 slots, held slots must survive ----------------
    ttl = 86400 * 1024
    active = torch.tensor(rng.integers(0, 3, n).astype(np.int32), device=dev)
    last = torch.tensor(rng.integers(now - 2 * ttl, now, n).astype(np.int32),
                        device=dev)
    exists0 = table[2]
    ks = K.SemaState(active, last, exists0.clone())
    ps = K.SemaState(active, last, exists0.clone())
    mask, counts = ck.sweep_semas(ks, now)
    _, expired = K.sweep_semas(ps, now)
    torch.cuda.synchronize()
    _check_equal("sweep_semas mask", mask.bool(), expired)
    _check_equal("sweep_semas exists", ks.exists, ps.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(
            -1, ck.TILE).sum(1)
    _check_equal("sweep_semas tile counts", counts, want_tiles.int())
    if bool((mask.bool() & (active > 0)).any()):
        raise AssertionError("sweep_semas evicted a slot that holds permits")
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep_semas expired {n_expired}: no mix")
    ms = _median_ms(lambda: ck.sweep_semas(ks, now),
                    setup=lambda: ks.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_semas(ps, now),
                          setup=lambda: ps.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_semas(ks, now),
                        ["sweep_semas_kernel"])
    # 11 B a slot (active, last_ts, exists read; exists, mask written) and
    # the tile counts; ~5 operations a slot.
    res["sweep_semas"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=11 * n + 4 * counts.numel(), ops=5 * n, device_ms=dev_ms)
    print(f"sweep_semas N={n}: expired {n_expired}, no held slot, equal to "
          f"plain; {ms:.4f} ms (plain {plain_ms:.4f} ms, device time "
          f"{dev_ms} ms)")
    del table, active, last, exists0, ks, ps
    torch.cuda.empty_cache()

    # -- acquire_hierarchical at B = 4096 on the LLM workload's rows ---------
    tenants, keys, costs, _ = _llm_workload(LLM_SEED, BATCH)
    cs, ps_ = _dense_ids(keys), _dense_ids(tenants)
    cs[rng.permutation(BATCH)[:40]] = -1
    m, now = LLM_SLOTS, 3_000_000
    packed = np.stack([cs, costs.astype(np.int32),
                       np.full(BATCH, now, np.int32), ps_])
    op = torch.from_numpy(packed).to(dev)
    per_tick = 1e5 / 1024
    err = 0.0
    for case, (ccap, pcap) in (("workload budgets", LLM_BUDGETS),
                               ("both budgets bind", (2e3, 5e3))):
        def bucket(cap):
            return (torch.tensor(rng.uniform(cap / 2, cap, m).astype(
                        np.float32), device=dev),
                    torch.tensor(rng.integers(now - 3000, now, m).astype(
                        np.int32), device=dev),
                    torch.tensor(rng.random(m) < 0.6, device=dev))
        ctab, ptab = bucket(ccap), bucket(pcap)
        kc, kp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
        pc, pp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
        args = (ccap, per_tick, pcap, per_tick)
        child_ok, granted, near = _hier_levels(torch, K, bm, pc, pp, op,
                                               *args)
        got = ck.acquire_hierarchical(kc, kp, op, *args)
        _, _, want = K.acquire_hierarchical_packed(pc, pp, op, *args)
        torch.cuda.synchronize()
        _check_equal(f"acquire_hierarchical ({case}) grants", got[0],
                     want[0])
        _check_equal(f"acquire_hierarchical ({case}) levels", want[0] > 0.5,
                     granted)
        err = max(err, _check_close(f"acquire_hierarchical ({case}) "
                                    "remaining", got[1], want[1]))
        for name, kt, pt in (("child", kc, pc), ("parent", kp, pp)):
            err = max(err, _check_close(
                f"acquire_hierarchical ({case}) {name} tokens", kt.tokens,
                pt.tokens))
            _check_equal(f"acquire_hierarchical ({case}) {name} last_ts",
                         kt.last_ts, pt.last_ts)
            _check_equal(f"acquire_hierarchical ({case}) {name} exists",
                         kt.exists, pt.exists)
        valid = torch.from_numpy((cs >= 0)).to(dev)
        deny_child = int((valid & ~child_ok).sum())
        deny_parent = int((child_ok & ~granted).sum())
        if case == "both budgets bind" and not (deny_child and deny_parent):
            raise AssertionError(f"acquire_hierarchical: denials at the key "
                                 f"{deny_child}, at the tenant "
                                 f"{deny_parent}: not both")
        line = (f"acquire_hierarchical B={BATCH} ({case}: key {ccap:g}, "
                f"tenant {pcap:g}; {len(set(keys))} keys, "
                f"{len(set(tenants))} tenants): grants equal to plain "
                f"({int(granted.sum())} granted, {deny_child} denied at the "
                f"key, {deny_parent} at the tenant, {int(near.sum())} near a "
                f"threshold), max abs err {err:.3g}")
        if case == "workload budgets":
            ms = _median_ms(lambda: ck.acquire_hierarchical(kc, kp, op,
                                                            *args), inner=20)
            plain_ms = _median_ms(lambda: K.acquire_hierarchical_packed(
                pc, pp, op, *args), reps=5, warmup=1)
            dev_ms = _device_ms(lambda: ck.acquire_hierarchical(kc, kp, op,
                                                                *args),
                                HIER_KERNELS)
            distinct = len(set(keys)) + len(set(tenants))
            # Bytes: the 16 B operand row and 8 B reply, 18 B per distinct
            # slot of either table. ~30 operations a row.
            res["acquire_hierarchical"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=24 * BATCH + 18 * distinct, ops=30 * BATCH,
                device_ms=dev_ms)
            line += (f"; {ms:.4f} ms (plain {plain_ms:.4f} ms, device time "
                     f"{dev_ms} ms)")
        print(line)
    # One valid row at B = 8, the shape of every reserve on the reservation
    # path (the store pads a one-row two-level call to 8 rows).
    one = np.full((4, 8), -1, np.int32)
    one[1] = 0
    one[2] = now
    one[:, 0] = (max(int(cs[0]), 0), int(costs[0]), now, int(ps_[0]))
    op1 = torch.from_numpy(one).to(dev)
    kc, kp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
    pc, pp = (K.BucketState(*(x.clone() for x in t)) for t in (ctab, ptab))
    got = ck.acquire_hierarchical(kc, kp, op1, *args)
    _, _, want = K.acquire_hierarchical_packed(pc, pp, op1, *args)
    torch.cuda.synchronize()
    _check_equal("acquire_hierarchical (one valid row) grants", got[0],
                 want[0])
    err1 = _check_close("acquire_hierarchical (one valid row) remaining",
                        got[1], want[1])
    for name, kt, pt in (("child", kc, pc), ("parent", kp, pp)):
        _check_equal(f"acquire_hierarchical (one valid row) {name} tokens",
                     kt.tokens, pt.tokens)
        _check_equal(f"acquire_hierarchical (one valid row) {name} last_ts",
                     kt.last_ts, pt.last_ts)
        _check_equal(f"acquire_hierarchical (one valid row) {name} exists",
                     kt.exists, pt.exists)
    ms = _median_ms(lambda: ck.acquire_hierarchical(kc, kp, op1, *args),
                    inner=20)
    dev_ms = _device_ms(lambda: ck.acquire_hierarchical(kc, kp, op1, *args),
                        HIER_KERNELS)
    bound_ms, bound_by = _bound_ms(24 * 8 + 18 * 2, 30 * 8)
    res["acquire_hierarchical"]["shapes"] = {"one valid row (B=8)": dict(
        ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
        max_abs_err=err1)}
    print(f"acquire_hierarchical B=8 (one valid row, the reservation "
          f"path's reserve): grants, tokens and state equal to plain, "
          f"remaining max abs err {err1!r}; {ms:.4f} ms (device time "
          f"{dev_ms} ms)")
    res["acquire_hierarchical"]["max_abs_err"] = max(err, err1)
    del kc, kp, pc, pp, ctab, ptab
    torch.cuda.empty_cache()

    # -- debit_packed: 2^20 distinct slots of a 2^24 table; 4096 with
    #    repeats, fractional and negative amounts; whole numbers with repeats
    #    at 4096 and 2^17 (tokens exact); one valid row ----------------------
    n, cap, rate = N_SLOTS, 100.0, 10 / 1024
    table = (torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                          device=dev),
             torch.tensor(rng.random(n) < 0.6, device=dev))
    # Whole balances, ticks on a 1024-tick grid (the refill adds a whole 10
    # a grid step): every partial sum of a whole-number debit is exact.
    whole = (torch.tensor(rng.integers(0, 100, n).astype(np.float32),
                          device=dev),
             torch.tensor((now - 1024 * rng.integers(0, 4, n)).astype(
                 np.int32), device=dev),
             table[2])
    shapes = {}
    for label, b, tab in (("distinct", min(2**20, n // 2), table),
                          ("repeats", BATCH, table),
                          ("whole repeats", BATCH, whole),
                          ("whole Zipf", 2**17, whole),
                          ("one valid row", 8, table)):
        if label == "distinct":
            slots = rng.choice(n, b, replace=False).astype(np.int32)
            amounts = rng.uniform(0, 120, b).astype(np.float32)
        elif label.startswith("whole"):
            slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
            amounts = rng.integers(-6, 15, b).astype(np.float32)
        else:
            slots = ((rng.zipf(1.2, b) - 1) % n).astype(np.int32)
            amounts = rng.uniform(-20, 60, b).astype(np.float32)
        slots[rng.permutation(b)[:b // 64]] = -1
        if label == "one valid row":
            slots[1:] = -1
        t_slots = torch.from_numpy(slots)
        prefix = bm.duplicate_prefix_float(t_slots, torch.from_numpy(amounts),
                                           t_slots >= 0)
        packed = np.stack([slots, amounts.view(np.int32),
                           np.full(b, now, np.int32),
                           prefix.numpy().view(np.int32)])
        op = torch.from_numpy(packed).to(dev)
        ks = K.BucketState(*(x.clone() for x in tab))
        ps = K.BucketState(*(x.clone() for x in tab))
        got = ck.debit_packed(ks, op, cap, rate)
        _, want = K.debit_batch_packed(ps, op, cap, rate)
        torch.cuda.synchronize()
        _check_equal(f"debit_packed ({label}) replies", got, want)
        _check_equal(f"debit_packed ({label}) last_ts", ks.last_ts,
                     ps.last_ts)
        _check_equal(f"debit_packed ({label}) exists", ks.exists, ps.exists)
        ok = slots >= 0
        reps = np.bincount(slots[ok], minlength=n)
        if label != "repeats":  # distinct slots, or whole numbers
            _check_equal(f"debit_packed ({label}) tokens", ks.tokens,
                         ps.tokens)
            derr = 0.0
        else:
            # The plain version's r atomic adds on a slot round by at most r
            # spacings of its largest partial sum (its value plus its
            # amounts' magnitudes); the kernel rounds the exact sum once.
            g, wt = ks.tokens.cpu().numpy(), ps.tokens.cpu().numpy()
            mag = np.abs(wt) + np.bincount(slots[ok], np.abs(amounts[ok]),
                                           minlength=n)
            tol = np.where(reps > 1, reps, 0) * np.spacing(
                mag.astype(np.float32))
            derr = float(np.abs(g.astype(np.float64) - wt).max())
            if not (np.abs(g.astype(np.float64) - wt) <= tol).all():
                raise AssertionError("debit_packed (repeats): a slot's "
                                     "tokens past its rounding limit")
        _check_twice(f"debit_packed ({label})",
                     lambda st: ck.debit_packed(st, op, cap, rate),
                     [K.BucketState(*(x.clone() for x in tab))
                      for _ in range(2)])
        short = float(want[1].sum())
        ms = _median_ms(lambda: ck.debit_packed(ks, op, cap, rate),
                        inner=5 if b > BATCH else 20)
        dev_ms = _device_ms(lambda: ck.debit_packed(ks, op, cap, rate),
                            DEBIT_KERNELS)
        d = int((reps > 0).sum())
        # Bytes: the 16 B operand row and 8 B reply, 18 B per distinct
        # slot. ~12 operations a row.
        bound_ms, bound_by = _bound_ms(24 * b + 18 * d, 12 * b)
        shapes[f"{label} (B={b})"] = dict(
            ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=derr)
        print(f"debit_packed B={b} ({label}, {d} distinct slots, max repeat "
              f"{reps.max()}): replies, last_ts and exists equal to plain, "
              f"tokens max abs err {derr!r}, two launches bit-equal; "
              f"shortfall {short:.1f} tokens; {ms:.4f} ms (device time "
              f"{dev_ms} ms)")
        if label == "distinct":
            plain_ms = _median_ms(lambda: K.debit_batch_packed(
                ps, op, cap, rate), reps=5, warmup=1)
            res["debit_packed"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=24 * b + 18 * b, ops=12 * b, device_ms=dev_ms)
        else:
            res["debit_packed"]["max_abs_err"] = max(
                res["debit_packed"]["max_abs_err"], derr)
    res["debit_packed"]["shapes"] = shapes
    return res



class _HierProbe:
    """Counts, while installed, the rows of every plain-version two-level
    launch (the CPU oracle's) whose margin at either level lies within
    float rounding of its threshold: wraps ``ck.acquire_hierarchical``,
    which the store calls through the module."""

    def __init__(self, torch, K, ck) -> None:
        from distributedratelimiting.redis_tpu_torch.ops import (
            bucket_math as bm,
        )

        self.near = 0
        real = ck.acquire_hierarchical

        def probed(child, parent, packed, *args):
            if child.tokens.device.type == "cpu":
                self.near += int(_hier_levels(torch, K, bm, child, parent,
                                              packed, *args)[2].sum())
            return real(child, parent, packed, *args)

        self._ck, self._real = ck, real
        ck.acquire_hierarchical = probed

    def remove(self) -> None:
        self._ck.acquire_hierarchical = self._real


def _llm_windows(tenants, keys, costs):
    """The 2,048-row windows of ``benchmarks/llm_workload.py`` (its
    FLUSH_WINDOW): ``(tenants, keys, costs)`` slices."""
    for s in range(0, len(keys), LLM_WINDOW):
        yield (tenants[s:s + LLM_WINDOW], keys[s:s + LLM_WINDOW],
               costs[s:s + LLM_WINDOW])


def _tenant_totals(tenants, costs, granted) -> dict:
    out: dict = {}
    for t, c, g in zip(tenants, costs, granted):
        if g:
            out[t] = out.get(t, 0) + int(c)
    return out


async def admission_path(torch, ck, pkg, card: str) -> dict:
    """Semaphores and two-level (tenant → key) admission in process, on a
    store of their own: returns the kernel launches the path made."""
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K
    from distributedratelimiting.redis_tpu_torch.runtime import admission

    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", n_slots=LLM_SLOTS,
                                  counter_slots=SEMA_SLOTS, max_batch=BATCH,
                                  clock=clock)
    await store.connect()
    ck.reset_launches()

    # 1. Semaphores at full size: one permit on each of 1M keys (limit 4),
    # then their release, one launch per 4,096-row chunk.
    keys = [f"lease:{i}" for i in range(N_SEMA_KEYS)]
    t0 = time.perf_counter()
    res = await store.concurrency_acquire_many(keys, [1] * len(keys), 4)
    acq_s = time.perf_counter() - t0
    if not (res.granted.all() and np.all(res.remaining == 1.0)):
        raise AssertionError("semaphore bulk: not every key holds 1")
    launches = ck.launches["sema_packed"]
    if launches != -(-len(keys) // ck.SEMA_MAX_BATCH):
        raise AssertionError(f"semaphore bulk: {launches} launches")
    t0 = time.perf_counter()
    res = await store.concurrency_acquire_many(keys, [-1] * len(keys), 4)
    rel_s = time.perf_counter() - t0
    if not (res.granted.all() and np.all(res.remaining == 0.0)):
        raise AssertionError("semaphore bulk release: not all granted")
    if int(store._semas.active.sum()) != 0:
        raise AssertionError("semaphore bulk release: permits still held")
    print(f"concurrency_acquire_many: {len(keys)} distinct keys x 1 permit "
          f"in {acq_s:.3f} s = {len(keys) / acq_s:.0f} ops/s, their release "
          f"in {rel_s:.3f} s = {len(keys) / rel_s:.0f} ops/s ({card}); "
          f"{launches} sema_packed launches each way; a {SEMA_SLOTS}-slot "
          f"table")

    # A batch whose keys mix a release with other rows (the hazard route:
    # such rows go one op at a time), against the port's CPU store.
    hz_keys = ["hz0", "hz1", "hz0", "hz2", "hz0", "hz1", "hz3", "hz0"]
    hz_deltas = [2, 3, -1, 1, 3, -5, 0, 1]
    oracle = pkg.DeviceBucketStore(device="cpu", counter_slots=64,
                                   clock=pkg.ManualClock(1_000_000))
    got = await store.concurrency_acquire_many(hz_keys, hz_deltas, 4)
    want = await oracle.concurrency_acquire_many(hz_keys, hz_deltas, 4)
    if (got.granted.tolist() != want.granted.tolist()
            or got.remaining.tolist() != want.remaining.tolist()):
        raise AssertionError(f"hazard batch: {got.granted.tolist()} "
                             f"{got.remaining.tolist()} vs the CPU store's "
                             f"{want.granted.tolist()} "
                             f"{want.remaining.tolist()}")
    print(f"concurrency_acquire_many, mixed-sign same-key rows: grants "
          f"{got.granted.tolist()}, held {got.remaining.tolist()}, equal to "
          f"the CPU store")

    # ConcurrencyLimiter(permit_limit=5): 32 concurrent acquires -> exactly
    # 5 leases; the queued waiters drained by dispose; a second limiter
    # with the same instance_name shares the semaphore.
    opts = pkg.ConcurrencyLimiterOptions(permit_limit=5, queue_limit=27,
                                         instance_name="cap5",
                                         retry_period_s=0.01)
    lim, twin = pkg.ConcurrencyLimiter(opts, store), pkg.ConcurrencyLimiter(
        opts, store)
    tasks = [asyncio.ensure_future(lim.acquire_async(1)) for _ in range(32)]
    deadline = time.monotonic() + 60
    while len(lim._queue) < 27:
        if time.monotonic() > deadline:
            raise AssertionError("cap-5 limiter: waiters never parked")
        await asyncio.sleep(0.001)
    held = [t.result() for t in tasks if t.done() and t.result()]
    if len(held) != 5 or twin.acquire(1).is_acquired or \
            twin.available_permits() != 0:
        raise AssertionError(f"cap-5 limiter: {len(held)} leases")
    await lim.aclose()
    rest = await asyncio.gather(*tasks)
    if sum(map(bool, rest)) != 5:
        raise AssertionError("cap-5 limiter: dispose granted a waiter")
    held[0].dispose()  # the twin can take the permit it returns
    lease = twin.acquire(1)
    if not lease.is_acquired:
        raise AssertionError("cap-5 limiter: the twin missed the release")
    await twin.aclose()
    print("ConcurrencyLimiter(permit_limit=5): 32 concurrent acquires -> 5 "
          "leases, 27 queued waiters failed by dispose, a twin limiter "
          "sharing the instance_name saw every held permit")

    # sweep_all a day later: exactly the zero-held slots go.
    dir_map = store._sema_dir.to_dict()
    active = store._semas.active.cpu().numpy()
    want_evicted = sum(1 for s in dir_map.values() if active[s] <= 0)
    held_keys = [k for k, s in dir_map.items() if active[s] > 0]
    evicted0 = store.metrics.slots_evicted
    clock.advance_seconds(86_401)
    t0 = time.perf_counter()
    store.sweep_all()
    sweep_s = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    if evicted != want_evicted or any(store._sema_dir.lookup(k) is None
                                      for k in held_keys):
        raise AssertionError(f"semaphore sweep evicted {evicted} of "
                             f"{want_evicted}; held slots {held_keys}")
    print(f"sweep_all a day later: evicted exactly the {want_evicted} "
          f"zero-held semaphore slots in {sweep_s:.3f} s, kept the "
          f"{len(held_keys)} that hold permits ({held_keys})")

    # 2. Two-level admission on the LLM workload (benchmarks/llm_workload.py,
    # recapture.py's device size): 2^16 rows, 2^18 slots, max_batch 4096.
    tenants, keys, costs, _ = _llm_workload(LLM_SEED, LLM_ROWS)
    tokens = int(costs.sum())
    oracle = pkg.DeviceBucketStore(device="cpu", n_slots=LLM_SLOTS,
                                   max_batch=BATCH,
                                   clock=pkg.ManualClock(clock.now_ticks()))
    ccap, tcap = LLM_BUDGETS
    rate = LLM_RATE
    probe = _HierProbe(torch, K, ck)
    try:
        h0 = ck.launches["acquire_hierarchical"]
        t0 = time.perf_counter()
        res = await store.acquire_hierarchical_many(
            tenants, keys, costs, tcap, rate, ccap, rate,
            with_remaining=False)
        arm1_s = time.perf_counter() - t0
        launches = ck.launches["acquire_hierarchical"] - h0
        want = await oracle.acquire_hierarchical_many(
            tenants, keys, costs, tcap, rate, ccap, rate,
            with_remaining=False)
        if res.granted.tolist() != want.granted.tolist():
            raise AssertionError("two-level admission (workload budgets): "
                                 "grants differ from the CPU store")
        print(f"acquire_hierarchical_many, LLM workload ({LLM_ROWS} rows, "
              f"64 Zipf(1.2) tenants, {len(set(keys))} keys, {tokens} "
              f"tokens; tenant {tcap:g} and key {ccap:g} tokens at "
              f"{rate:g}/s): {res.granted_count} granted in {arm1_s:.3f} s "
              f"= {LLM_ROWS / arm1_s:.0f} rows/s, {tokens / arm1_s:.0f} "
              f"tokens/s ({card}); {launches} launches; grants equal to the "
              f"CPU store row by row")
        # The binding arm: the tenant budget lowered to 5e4 tokens, the
        # clock 10 ticks on before each 2,048-row window.
        btcap = LLM_BINDING_TENANT
        granted, t_total, start = [], 0.0, clock.now_ticks()
        for wt, wk, wc in _llm_windows(tenants, keys, costs):
            clock.advance_ticks(LLM_STEP_TICKS)
            oracle.clock.advance_ticks(LLM_STEP_TICKS)
            t0 = time.perf_counter()
            r = await store.acquire_hierarchical_many(wt, wk, wc, btcap,
                                                      rate, ccap, rate)
            t_total += time.perf_counter() - t0
            o = await oracle.acquire_hierarchical_many(wt, wk, wc, btcap,
                                                       rate, ccap, rate)
            if r.granted.tolist() != o.granted.tolist():
                raise AssertionError("two-level admission (binding): grants "
                                     "differ from the CPU store")
            granted.append(r.granted)
        granted = np.concatenate(granted)
        denied = 1.0 - granted.mean()
        if denied < 1 / 3:
            raise AssertionError(f"binding arm denied only {denied:.3f}")
        elapsed_s = (clock.now_ticks() - start) / pkg.TICKS_PER_SECOND
        over = {t: v for t, v in _tenant_totals(tenants, costs,
                                                granted).items()
                if v > btcap + rate * elapsed_s}
        if over:
            raise AssertionError(f"tenants past budget + refill: {over}")
        btokens = int(costs[granted].sum())
        print(f"acquire_hierarchical_many, binding arm (tenant {btcap:g} "
              f"tokens at {rate:g}/s, {LLM_STEP_TICKS} ticks between "
              f"{LLM_WINDOW}-row windows): {granted.sum()} of {LLM_ROWS} "
              f"granted ({denied:.1%} denied), {btokens} tokens admitted; "
              f"{LLM_ROWS / t_total:.0f} rows/s, {tokens / t_total:.0f} "
              f"tokens/s offered ({card}); every tenant within budget + "
              f"refill; grants equal to the CPU store")
        # AdmissionPolicy.acquire: one decision (one launch) a row.
        pols = [admission.AdmissionPolicy(s, key_config=(ccap, rate))
                for s in (store, oracle)]
        for pol in pols:
            for t in sorted(set(tenants)):
                pol.set_tenant(admission.TenantBudget(t, btcap, rate))
        n_pol = LLM_POLICY_ROWS
        t0 = time.perf_counter()
        got = [bool(await pols[0].acquire(tenants[i], keys[i],
                                          int(costs[i])))
               for i in range(n_pol)]
        pol_s = time.perf_counter() - t0
        want = [bool(await pols[1].acquire(tenants[i], keys[i],
                                           int(costs[i])))
                for i in range(n_pol)]
        if got != want or pols[0].stats()["admitted_tokens"] != \
                pols[1].stats()["admitted_tokens"]:
            raise AssertionError("AdmissionPolicy.acquire: grants differ "
                                 "from the CPU store")
        print(f"AdmissionPolicy.acquire: {n_pol} rows one at a time in "
              f"{pol_s:.3f} s = {n_pol / pol_s:.0f} rows/s ({card}); "
              f"{sum(got)} granted, admitted tokens "
              f"{pols[0].stats()['admitted_tokens']:g}, equal to the CPU "
              f"store")
    finally:
        probe.remove()
    # Rows whose margin is within two float32 spacings of a threshold are
    # where another rounding (XLA's FMA, an exact oracle) could decide
    # otherwise; the kernel and the CPU store round alike, so their grants
    # are compared exactly above whatever this count is.
    print(f"two-level admission: {probe.near} rows within float rounding of "
          f"a threshold in the CPU store's launches (0 expected)")
    counts = dict(ck.launches)
    await store.aclose()
    await oracle.aclose()
    return counts


#: The reservation path at the JAX package's device debt for the lane
#: (``benchmarks/recapture.py:174-214``): 2^13 rows of the LLM workload on a
#: 2^16-slot store, ``max_batch`` 1024, estimates cost x LogNormal(0, 0.55)
#: from their own seed (``benchmarks/llm_workload.py:263-271``); the
#: zero-fill audit arm (``benchmarks/llm_workload.py:325-362``): 8,000 rows,
#: tenant budget 20,000 tokens, fill 1e-9.
RESV_ROWS = 8192
RESV_SLOTS = 2**16
RESV_MAX_BATCH = 1024
RESV_EST_SIGMA = 0.55
RESV_ERR_SEED = 0x5E771E
RESV_AUDIT_ROWS = 8000
RESV_AUDIT_TENANT = 20_000.0
RESV_AUDIT_FILL = 1e-9
#: Reserve/settle pairs over the wire, and the TTL arm's hold TTL.
N_WIRE_RESV = 1000
RESV_TTL_S = 5.0
#: Pairs profiled for the device time of a reserve + settle.
RESV_PROFILED = 256


def _time_async(obj, name: str, acc: list) -> None:
    """Wrap the coroutine method ``obj.name`` so that its awaited wall time
    accrues to ``acc[0]``."""
    fn = getattr(obj, name)

    async def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return await fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t

    setattr(obj, name, timed)


async def _drive_reservations(store, tenants, keys, costs, estimates, prios,
                              tcap, trate, prefix, clock=None):
    """Reserve, then settle at its cost, every row serially through the
    store's ledger (``benchmarks/llm_workload.py:279-300``); ``clock``,
    when given, advances one tick before each row. Returns ``(settled rows,
    settled tokens, [(ReserveResult, SettleResult or None)], ledger)``."""
    led = store.reservation_ledger()
    ccap, crate = LLM_BUDGETS[0], LLM_RATE
    granted = settled = 0
    rows = []
    for i in range(len(keys)):
        if clock is not None:
            clock.advance_ticks(1)
        r = await led.reserve(f"{prefix}{i}", tenants[i], keys[i],
                              float(estimates[i]), tcap, trate, ccap, crate,
                              priority=int(prios[i]))
        s = None
        if r.granted:
            s = await led.settle(f"{prefix}{i}", tenants[i], float(costs[i]))
            if s.outcome == "settled":
                granted += 1
                settled += int(costs[i])
        rows.append((r, s))
    return granted, settled, rows, led


def _resv_compare(what, got, want, tol) -> float:
    """Hold one run's reservation rows and ledger to another's: grants,
    outcomes, flags and integer counters equal; float fields, balances and
    debts within ``tol``. Returns the largest float difference."""
    (g_rows, g_led), (w_rows, w_led) = got, want
    err = 0.0
    for i, ((gr, gs), (wr, ws)) in enumerate(zip(g_rows, w_rows,
                                                 strict=True)):
        if gr.granted != wr.granted or gr[4:] != wr[4:] or \
                (gs is None) != (ws is None) or \
                (gs is not None and gs.outcome != ws.outcome):
            raise AssertionError(f"{what}: row {i} {gr} {gs} vs {wr} {ws}")
        pairs = list(zip(gr[1:4], wr[1:4]))
        if gs is not None:
            pairs += list(zip(gs[1:], ws[1:]))
        for a, b in pairs:
            err = max(err, abs(a - b))
    gs_, ws_ = g_led.numeric_stats(), w_led.numeric_stats()
    for k, v in gs_.items():
        if isinstance(v, int) and v != ws_[k]:
            raise AssertionError(f"{what}: counter {k} {v} vs {ws_[k]}")
        err = max(err, abs(v - ws_[k]))
    gd, wd = g_led.debts(), w_led.debts()
    if gd.keys() != wd.keys():
        raise AssertionError(f"{what}: debtors {sorted(gd)} vs {sorted(wd)}")
    err = max([err] + [abs(v - wd[t]) for t, v in gd.items()])
    if err > tol:
        raise AssertionError(f"{what}: a float field differs by {err}")
    return err


async def reservation_path(torch, ck, pkg, card: str) -> dict:
    """The estimate-reserve-settle lane on the card: the LLM workload
    reserved at its estimates and settled at its costs through the store's
    ledger (one ``acquire_hierarchical`` launch a reserve, one or two
    ``debit_packed`` launches a settle or a debt collection), held to the
    port's CPU store on the same clock schedule; the zero-fill audit arm;
    the lane over the wire; the TTL auto-settle. Returns the kernel
    launches the path made."""
    from torch.profiler import ProfilerActivity, profile

    from distributedratelimiting.redis_tpu_torch.runtime import (
        reservations,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import store as smod

    ccap, tcap = LLM_BUDGETS
    rate = LLM_RATE
    tenants, keys, costs, prios = _llm_workload(LLM_SEED, RESV_ROWS)
    rng = np.random.default_rng(RESV_ERR_SEED)
    estimates = np.maximum(costs * rng.lognormal(0.0, RESV_EST_SIGMA,
                                                 RESV_ROWS), 1.0)

    def card_store(clock):
        return pkg.DeviceBucketStore(device="cuda", n_slots=RESV_SLOTS,
                                     max_batch=RESV_MAX_BATCH, clock=clock)

    clock = pkg.ManualClock(1_000_000)
    store = card_store(clock)
    await store.connect()
    ck.reset_launches()

    # 1. Throughput at the device debt's size: 8,192 pairs, serially, one
    # tick a row. The store's awaits and their host dispatch are timed.
    t_hier, t_debit, t_hdisp, t_ddisp = [0.0], [0.0], [0.0], [0.0]
    _time_async(store, "acquire_hierarchical", t_hier)
    _time_async(store, "debit_many", t_debit)
    _time_calls(store, "_hier_dispatch", t_hdisp)
    real_launch = smod._DeviceTable._debit_launch
    _time_calls(smod._DeviceTable, "_debit_launch", t_ddisp)
    h0, d0 = ck.launches["acquire_hierarchical"], ck.launches["debit_packed"]
    try:
        t0 = time.perf_counter()
        granted, settled, rows, led = await _drive_reservations(
            store, tenants, keys, costs, estimates, prios, tcap, rate, "r",
            clock)
        wall = time.perf_counter() - t0
    finally:
        smod._DeviceTable._debit_launch = real_launch
    n_hier = ck.launches["acquire_hierarchical"] - h0
    n_debit = ck.launches["debit_packed"] - d0
    if n_hier != RESV_ROWS:
        raise AssertionError(f"reservations: {n_hier} two-level launches for "
                             f"{RESV_ROWS} reserves")
    refund_ratio = led.refunded_tokens / max(settled, 1)
    debt_ratio = led.debt_tokens_created / max(settled, 1)
    cons = led.conservation()
    if abs(cons["residue"]) > 1e-6 * max(cons["inflow"], 1.0):
        raise AssertionError(f"reservations: conservation residue {cons}")
    store_s = t_hier[0] + t_debit[0]
    disp_s = t_hdisp[0] + t_ddisp[0]
    print(f"reservations (LLM workload, {RESV_ROWS} rows, estimates cost x "
          f"LogNormal(0, {RESV_EST_SIGMA}); tenant {tcap:g} and key "
          f"{ccap:g} tokens at {rate:g}/s; {int(costs.sum())} tokens of "
          f"cost as numpy {np.__version__} draws them; a {RESV_SLOTS}-slot "
          f"store, max_batch {RESV_MAX_BATCH}): {granted} pairs settled in "
          f"{wall:.3f} s = {RESV_ROWS / wall:.0f} pairs/s, "
          f"{settled / wall:.0f} settled tokens/s ({card}); refund_ratio "
          f"{refund_ratio:.4f}, debt_ratio {debt_ratio:.4f}; "
          f"{n_hier} acquire_hierarchical and {n_debit} debit_packed "
          f"launches; conservation residue {cons['residue']!r}")
    print(f"reservations, where a pair's {wall / RESV_ROWS * 1e3:.4f} ms "
          f"goes: store awaits {store_s / RESV_ROWS * 1e3:.4f} ms "
          f"(two-level {t_hier[0] / RESV_ROWS * 1e3:.4f}, debits "
          f"{t_debit[0] / RESV_ROWS * 1e3:.4f}), of which host dispatch "
          f"(resolve, operand, launch) {disp_s / RESV_ROWS * 1e3:.4f} ms "
          f"and the readback with its executor hop "
          f"{(store_s - disp_s) / RESV_ROWS * 1e3:.4f} ms; the ledger's "
          f"own host work (lock, expiry, dicts) "
          f"{(wall - store_s) / RESV_ROWS * 1e3:.4f} ms")
    # 2. The same schedule on the port's CPU store: grants, outcomes and
    # integer counters equal; floats within 2 float32 spacings of the
    # tenant budget (the tests' tolerance for balances).
    oclock = pkg.ManualClock(1_000_000)
    oracle = pkg.DeviceBucketStore(device="cpu", n_slots=RESV_SLOTS,
                                   max_batch=RESV_MAX_BATCH, clock=oclock)
    t0 = time.perf_counter()
    _g, o_settled, o_rows, o_led = await _drive_reservations(
        oracle, tenants, keys, costs, estimates, prios, tcap, rate, "r",
        oclock)
    cpu_s = time.perf_counter() - t0
    tol = 2 * float(np.spacing(np.float32(tcap)))
    err = _resv_compare("reservations vs the CPU store", (rows, led),
                        (o_rows, o_led), tol)
    if o_settled != settled:
        raise AssertionError(f"reservations: settled {settled} vs the CPU "
                             f"store's {o_settled}")
    print(f"reservations vs the port's CPU store on the same clock "
          f"schedule: every grant, outcome, integer counter and debtor "
          f"equal; float fields max abs diff {err!r} (limit {tol:g}); the "
          f"CPU store's plain versions took {cpu_s:.3f} s = "
          f"{RESV_ROWS / cpu_s:.0f} pairs/s")
    await oracle.aclose()

    # Device time of a pair: a profiled sample past the timed run.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        await _drive_reservations(
            store, tenants[:RESV_PROFILED], keys[:RESV_PROFILED],
            costs[:RESV_PROFILED], estimates[:RESV_PROFILED],
            prios[:RESV_PROFILED], tcap, rate, "p", clock)
        torch.cuda.synchronize()
    dev_us = {name: sum(getattr(e, "self_device_time_total", 0.0)
                        for e in prof.key_averages()
                        if any(k in e.key for k in kern))
              for name, kern in (("two-level", HIER_KERNELS),
                                 ("debit", DEBIT_KERNELS))}
    dev_ms = sum(dev_us.values()) / 1e3 / RESV_PROFILED
    print(f"reservations, device time a pair ({RESV_PROFILED} pairs "
          f"profiled): {dev_ms:.5f} ms (two-level "
          f"{dev_us['two-level'] / 1e3 / RESV_PROFILED:.5f}, debits "
          f"{dev_us['debit'] / 1e3 / RESV_PROFILED:.5f}), "
          f"{dev_ms / (wall / RESV_ROWS * 1e3):.2%} of a pair's wall "
          f"time")

    # 3. The zero-fill audit arm: store-observed spend per tenant against
    # the ledger's accounting, and the perfect-estimate oracle's bound.
    m = RESV_AUDIT_ROWS
    a_store = card_store(pkg.ManualClock(1_000_000))
    _g, a_settled, _rows, a_led = await _drive_reservations(
        a_store, tenants[:m], keys[:m], costs[:m], estimates[:m], prios[:m],
        RESV_AUDIT_TENANT, RESV_AUDIT_FILL, "a")
    spend = sum(RESV_AUDIT_TENANT - a_store.peek_blocking(
        t, RESV_AUDIT_TENANT, RESV_AUDIT_FILL) for t in set(tenants[:m]))
    debt_out = sum(a_led.debts().values())
    drift = (abs(spend - (a_settled - debt_out)) / a_settled
             if a_settled else 0.0)
    p_store = card_store(pkg.ManualClock(1_000_000))
    _g, o_settled, _rows, _led = await _drive_reservations(
        p_store, tenants[:m], keys[:m], costs[:m], costs[:m], prios[:m],
        RESV_AUDIT_TENANT, RESV_AUDIT_FILL, "o")
    epsilon = a_led.debt_tokens_created + 0.01 * o_settled
    bound_ok = a_settled <= o_settled + epsilon
    print(f"reservations, zero-fill audit ({m} rows, tenant "
          f"{RESV_AUDIT_TENANT:g} tokens, fill {RESV_AUDIT_FILL:g}): settled "
          f"{a_settled}, store-observed spend {spend:.1f}, debt created "
          f"{a_led.debt_tokens_created:.1f} and outstanding {debt_out:.1f}, "
          f"net_drift {drift!r}; the perfect-estimate oracle settled "
          f"{o_settled}, bound_ok {bound_ok} ({a_led.debt_denials} debt "
          f"denials, {a_led.reserve_denied} denials)")
    if not (drift <= 0.01 and bound_ok):
        raise AssertionError(f"reservation audit: net_drift {drift}, "
                             f"bound_ok {bound_ok}")
    await p_store.aclose()

    # 4. The wire: a server over a card store, the port's client, 1,000
    # pairs; retried reserves and settles debit nothing twice; an unknown
    # rid; OP_STATS' section against the server's ledger.
    w_store = card_store(pkg.ManualClock(1_000_000))
    server = pkg.BucketStoreServer(w_store, host="127.0.0.1", port=0)
    addr = await server.start()
    cli = pkg.RemoteBucketStore(address=addr, coalesce_requests=False)
    try:
        n = N_WIRE_RESV
        lat, w_granted = [], 0
        t0 = time.perf_counter()
        for i in range(n):
            t1 = time.perf_counter()
            r = await cli.reserve(f"w{i}", tenants[i], keys[i],
                                  float(estimates[i]), tcap, rate, ccap,
                                  rate, priority=int(prios[i]))
            if r.granted:
                w_granted += 1
                await cli.settle(f"w{i}", tenants[i], float(costs[i]))
            lat.append(time.perf_counter() - t1)
        w_wall = time.perf_counter() - t0
        w_led = server.reservations
        if w_granted != n or w_led.settles != n:
            raise AssertionError(f"wire reservations: {w_granted} granted, "
                                 f"{w_led.settles} settled of {n}")
        t, k = tenants[0], keys[0]

        def balances():
            return (w_store.peek_blocking(t, tcap, rate),
                    w_store.peek_blocking(k, ccap, rate))

        hold = await cli.reserve("dup", t, k, 500.0, tcap, rate, ccap, rate)
        before = balances()
        again = await cli.reserve("dup", t, k, 500.0, tcap, rate, ccap, rate)
        if not (hold.granted and again.granted and again.duplicate) or \
                balances() != before:
            raise AssertionError(f"wire reserve retry: {hold} {again} "
                                 f"{before} -> {balances()}")
        s1 = await cli.settle("dup", t, 200.0)
        after_settle = balances()
        s2 = await cli.settle("dup", t, 200.0)
        ghost = await cli.settle("ghost", t, 5.0)
        if s1.outcome != "settled" or s1.refunded != 300.0 or \
                s2.outcome != "duplicate" or balances() != after_settle or \
                ghost.outcome != "unknown":
            raise AssertionError(f"wire settle retry: {s1} {s2} {ghost}")
        stats = await cli.stats()
        section = stats["reservations"]
        mine = w_led.numeric_stats()
        if {k_: section[k_] for k_ in mine} != mine:
            raise AssertionError(f"OP_STATS reservations {section} vs the "
                                 f"server's ledger {mine}")
        print(f"reservations over the wire: {n} reserve/settle pairs in "
              f"{w_wall:.3f} s = {n / w_wall:.0f} pairs/s ({card}), client "
              f"p50 {_pct(lat, 50) * 1e3:.3f} ms, p99 "
              f"{_pct(lat, 99) * 1e3:.3f} ms a pair; a retried reserve "
              f"answered duplicate and a retried settle "
              f"{s2.outcome!r}, balances unchanged {before} -> "
              f"{after_settle} (the refund of 300); an unknown rid "
              f"{ghost.outcome!r}; OP_STATS' reservations section equal to "
              f"the server's ledger ({mine['reserves']} reserves, "
              f"{mine['settles']} settles)")
    finally:
        await cli.aclose()
        await server.aclose()

    # 5. TTL: an in-process ledger on an injected clock auto-settles an
    # unsettled hold at its estimate; a later settle replays that record.
    now = [0.0]
    t_led = reservations.ReservationLedger(
        w_store, clock=lambda: now[0], default_ttl_s=RESV_TTL_S)
    t, k = "tenant:ttl", "ttl/u0"
    r = await t_led.reserve("ttl1", t, k, 100.0, tcap, rate, ccap, rate)
    held = w_store.peek_blocking(t, tcap, rate)
    now[0] = RESV_TTL_S + 1.0
    expired = t_led.expire()
    record = t_led._settled.get("ttl1")
    replay = await t_led.settle("ttl1", t, 40.0)
    if not (r.granted and expired == 1 and t_led.ttl_expired == 1
            and record is not None and record.outcome == "expired"
            and replay.outcome == "duplicate" and replay.refunded == 0.0
            and t_led.outstanding_count() == 0
            and w_store.peek_blocking(t, tcap, rate) == held):
        raise AssertionError(f"reservation TTL: {r} {expired} {record} "
                             f"{replay}")
    print(f"reservation TTL ({RESV_TTL_S:g} s on the ledger's clock): the "
          f"unsettled hold of 100 auto-settled at its estimate "
          f"(ttl_expired {t_led.ttl_expired}, recorded outcome "
          f"{record.outcome!r}); a later settle replayed it "
          f"({replay.outcome!r}, refunded {replay.refunded}), the tenant's "
          f"balance unchanged at {held}")
    counts = dict(ck.launches)
    for st in (store, a_store, w_store):
        await st.aclose()
    return counts


#: The checkpoint path: the serial oracle's schedule (1M Zipf(1.1) bucket
#: draws in calls of CKPT_CALL_ROWS, one count a call; 4,096 acquire_async;
#: 65,536 two-level rows in calls of 4,096 distinct tenants and keys; a debit
#: of 2^16 keys; 2^16 fixed-window draws), then the chain at the main path's
#: size (10M bucket keys, 1M sliding-window keys, 2^16 counters, 2^16 held
#: semaphores), its delta of 500,000 re-acquired and 10,000 new keys.
CKPT_SEED = 1414
CKPT_DRAWS = 1_000_000
CKPT_CALL_ROWS = 125_000
CKPT_ASYNC = 4096
CKPT_HIER_ROWS = 2**16
CKPT_HIER_CALL = 4096
CKPT_HIER_POOL = 6000
CKPT_DEBIT_KEYS = 2**16
CKPT_FWINDOW_DRAWS = 2**16
CKPT_FWINDOW_CALL = 8192
CKPT_LIMIT, CKPT_RATE = 100.0, 10.0  # integer rates: 2^-10 multiples a tick
CKPT_HIER = ((24.0, 2.0), (12.0, 1.0))  # (tenant, key) budgets and rates
CKPT_FWINDOW = (8.0, 1.0)  # fixed window: limit, seconds
CKPT_WINDOW_KEYS = 1_000_000
CKPT_COUNTERS = 2**16
CKPT_SEMAS = 2**16
CKPT_REACQUIRE = 500_000
CKPT_NEW_KEYS = 10_000
CKPT_FILL_CALL = 1_000_000
#: The chain's bucket keys: 2M since the drain path joined the script (4M
#: since the fp path did, 10M before): with the drain path the whole script
#: took 1,169 s at 4M, against the 1,100 s it keeps under its 1,200 s limit.
CKPT_CHAIN_KEYS = 2_000_000
#: The bench's child sections, once each with a short window.
#: Halved (from 40 requests a worker and 2,048 samples) when the drain
#: path joined the script.
CKPT_BENCH = {
    "nproc": {"clients": 4, "workers": 64, "reqs": 20, "warm_workers": 32,
              "warm_reqs": 5},
    "serving_p99_colocated": {"samples": 1024, "min_reqs": 32,
                              "warm_reqs": 10},
    "serving_p99_instant": {"samples": 1024, "min_reqs": 32,
                            "warm_reqs": 10},
}


def _oracle_rows(what, keys, got, want, count) -> int:
    """Hold one card call to the serial store's answers for the same rows:
    grants equal on every row; ``remaining`` equal on every row but a denied
    row after an earlier denied row of its key in one decision, where the
    card's conservative same-key prefix (a denied row's demand still reserves
    ahead of later ones) reports 0 and the serial store the balance, which
    is below ``count``: there either value is exact. Returns how many rows
    reported the conservative 0."""
    g_ok = np.asarray(got.granted, bool)
    if not np.array_equal(g_ok, np.asarray(want.granted, bool)):
        bad = np.nonzero(g_ok != np.asarray(want.granted, bool))[0]
        raise AssertionError(f"{what}: grants differ at {bad.size} rows, "
                             f"first {keys[bad[0]]!r}")
    _, code = np.unique(np.asarray(keys, dtype=object).astype(str),
                        return_inverse=True)
    order = np.argsort(code, kind="stable")
    c = code[order]
    start = np.r_[True, c[1:] != c[:-1]]
    seg = np.cumsum(start) - 1
    first = np.nonzero(start)[0]
    rank = np.arange(len(c)) - first[seg]
    g = g_ok[order].astype(np.int64)
    before = np.cumsum(g) - g
    before -= before[first][seg]
    later = np.empty(len(c), bool)
    later[order] = (g == 0) & (rank > before)
    gr, wr = np.asarray(got.remaining), np.asarray(want.remaining)
    same = gr == wr
    if not same[~later].all():
        i = np.nonzero(~same & ~later)[0][0]
        raise AssertionError(f"{what}: remaining {gr[i]} vs {wr[i]} at "
                             f"{keys[i]!r}")
    cons = later & ~same
    if not ((gr[cons] == 0.0) & (wr[cons] < count)).all():
        raise AssertionError(f"{what}: a later denied row is neither the "
                             "serial balance nor the conservative 0")
    return int(cons.sum())


def _states_equal(what, card, serial) -> int:
    """Every bucket and fixed-window entry of the serial store against the
    card store's slot of its key: tokens and timestamps, window counts and
    indices, equal. Returns the entries compared."""
    snap = card.snapshot()
    n = 0
    by_cfg: dict = {}
    for (key, cap, rate), entry in serial._buckets.items():
        by_cfg.setdefault((cap, rate), []).append((key, entry))
    for cfg, rows in by_cfg.items():
        t = snap["tables"][cfg]
        d = t["directory"]
        slots = np.array([d[k] for k, _ in rows])
        tokens = np.array([e[0] for _, e in rows], np.float32)
        ts = np.array([e[1] for _, e in rows], np.int64)
        if not (np.array_equal(t["tokens"][slots], tokens)
                and np.array_equal(t["last_ts"][slots].astype(np.int64), ts)
                and t["exists"][slots].all() and len(d) == len(rows)):
            raise AssertionError(f"{what}: bucket table {cfg} differs")
        n += len(rows)
    for (key, limit, wt, interp), (prev, curr, idx) in \
            serial._windows.items():
        t = snap["wtables"][(limit, wt, not interp)]
        s = t["directory"][key]
        if (t["prev_count"][s], t["curr_count"][s],
                int(t["window_idx"][s])) != (prev, curr, idx):
            raise AssertionError(f"{what}: window {key!r} differs")
        n += 1
    return n


async def serial_oracle(pkg, card: str) -> None:
    """The serial ``InProcessBucketStore`` and a card ``DeviceBucketStore``
    of 2^24 slots on one ManualClock schedule, grants and balances held
    exactly (integer rates per second make a tick's refill a multiple of
    2^-10, exact in float32 below 2^14 tokens)."""
    rng = np.random.default_rng(CKPT_SEED)
    clock = pkg.ManualClock(1_000_000)
    dev = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS, clock=clock)
    ser = pkg.InProcessBucketStore(clock=clock)
    await dev.connect()
    t_ser, t_dev, conservative = [0.0], [0.0], 0
    _time_async(ser, "acquire_many", t_ser)
    _time_async(dev, "acquire_many", t_dev)
    draws = rng.zipf(1.1, CKPT_DRAWS)
    keys_all = [f"z{v}" for v in draws]
    for pos in range(0, CKPT_DRAWS, CKPT_CALL_ROWS):
        keys = keys_all[pos:pos + CKPT_CALL_ROWS]
        count = int(rng.integers(1, 4))
        counts = [count] * len(keys)
        got = await dev.acquire_many(keys, counts, CKPT_LIMIT, CKPT_RATE)
        want = await ser.acquire_many(keys, counts, CKPT_LIMIT, CKPT_RATE)
        conservative += _oracle_rows(f"oracle bulk at {pos}", keys, got,
                                     want, count)
        clock.advance_ticks(int(rng.integers(1, 3000)))
    # 4,096 concurrent acquire_async through the card's batcher.
    keys = [f"z{v}" for v in rng.zipf(1.1, CKPT_ASYNC)]
    got = await asyncio.gather(*(dev.acquire(k, 1, CKPT_LIMIT, CKPT_RATE)
                                 for k in keys))
    want = [await ser.acquire(k, 1, CKPT_LIMIT, CKPT_RATE) for k in keys]

    class _Rows:
        def __init__(self, rs):
            self.granted = np.array([r.granted for r in rs])
            self.remaining = np.array([r.remaining for r in rs], np.float32)

    conservative += _oracle_rows("oracle acquire_async", keys, _Rows(got),
                                 _Rows(want), 1)
    n_async_granted = sum(r.granted for r in got)
    # Two-level rows: distinct tenants and keys within each call (the card
    # serializes same-key and same-tenant rows conservatively on both
    # levels), repeats across calls.
    (tcap, trate), (kcap, krate) = CKPT_HIER
    tenants_pool = [f"tenant{i}" for i in range(CKPT_HIER_CALL)]
    h_granted = 0
    for _ in range(CKPT_HIER_ROWS // CKPT_HIER_CALL):
        clock.advance_ticks(int(rng.integers(1, 2048)))
        tenants = [tenants_pool[i] for i in rng.permutation(CKPT_HIER_CALL)]
        keys = [f"h{i}" for i in rng.choice(CKPT_HIER_POOL, CKPT_HIER_CALL,
                                            replace=False)]
        counts = rng.integers(1, 9, CKPT_HIER_CALL)
        got = await dev.acquire_hierarchical_many(tenants, keys, counts,
                                                  tcap, trate, kcap, krate)
        want = await ser.acquire_hierarchical_many(tenants, keys, counts,
                                                   tcap, trate, kcap, krate)
        if not (np.array_equal(got.granted, want.granted)
                and np.array_equal(got.remaining, want.remaining)):
            raise AssertionError("oracle two-level rows differ")
        h_granted += int(got.granted.sum())
    # One debit of 2^16 distinct keys (of the bulk's and new ones), halves
    # and credits included.
    distinct = list(dict.fromkeys(keys_all))
    dkeys = distinct[:CKPT_DEBIT_KEYS - 1000] + [f"d{i}" for i in range(1000)]
    amounts = rng.integers(-8, 40, len(dkeys)) * 0.5
    clock.advance_ticks(int(rng.integers(1, 2048)))
    g_rem, g_short = await dev.debit_many(dkeys, amounts, CKPT_LIMIT,
                                          CKPT_RATE)
    w_rem, w_short = await ser.debit_many(dkeys, amounts, CKPT_LIMIT,
                                          CKPT_RATE)
    if not (np.array_equal(g_rem, w_rem) and np.array_equal(g_short,
                                                            w_short)):
        raise AssertionError("oracle debit: remaining or shortfall differ")
    # Fixed-window draws across window boundaries.
    limit, wsec = CKPT_FWINDOW
    fw_granted = 0
    wdraws = [f"w{v}" for v in rng.zipf(1.1, CKPT_FWINDOW_DRAWS)]
    for pos in range(0, CKPT_FWINDOW_DRAWS, CKPT_FWINDOW_CALL):
        keys = wdraws[pos:pos + CKPT_FWINDOW_CALL]
        got = await dev.window_acquire_many(keys, [1] * len(keys), limit,
                                            wsec, fixed=True)
        want = await ser.window_acquire_many(keys, [1] * len(keys), limit,
                                             wsec, fixed=True)
        if not (np.array_equal(got.granted, want.granted)
                and np.array_equal(got.remaining, want.remaining)):
            raise AssertionError(f"oracle fixed windows differ at {pos}")
        fw_granted += int(got.granted.sum())
        clock.advance_ticks(int(rng.integers(0, 700)))
    n_state = _states_equal("oracle state", dev, ser)
    print(f"serial oracle ({card}): {CKPT_DRAWS} Zipf(1.1) bucket draws over "
          f"{len(distinct)} keys in {CKPT_DRAWS // CKPT_CALL_ROWS} bulk calls "
          f"(limit {CKPT_LIMIT:g}, {CKPT_RATE:g}/s), {CKPT_ASYNC} "
          f"acquire_async ({n_async_granted} granted), {CKPT_HIER_ROWS} "
          f"two-level rows ({h_granted} granted), a debit of {len(dkeys)} "
          f"keys, {CKPT_FWINDOW_DRAWS} fixed-window draws ({fw_granted} "
          f"granted): grants and remaining equal (conservative 0 on "
          f"{conservative} later denied same-key rows, the serial balance "
          f"below the count there), debit remaining/shortfall equal, and "
          f"{n_state} entries' state equal; bulk {CKPT_DRAWS} rows: serial "
          f"{t_ser[0]:.2f} s ({CKPT_DRAWS / t_ser[0]:.0f} decisions/s), card "
          f"{t_dev[0]:.2f} s ({CKPT_DRAWS / t_dev[0]:.0f} decisions/s)")
    await dev.aclose()


class _HoldTimer:
    """Stands in for a store's ``RLock`` and times its outermost holds."""

    def __init__(self, lock) -> None:
        self._lock = lock
        self._depth = 0
        self._t0 = 0.0
        self.longest = 0.0

    def __enter__(self):
        self._lock.acquire()
        if self._depth == 0:
            self._t0 = time.perf_counter()
        self._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        self._depth -= 1
        if self._depth == 0:
            self.longest = max(self.longest, time.perf_counter() - self._t0)
        self._lock.release()


def _snapshots_equal(what, a, b) -> None:
    """Two snapshots equal key for key and array for array (a mapping of
    plain values, such as a key directory, compares in one ``==``)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise AssertionError(f"{what}: keys differ")
        if not any(isinstance(v, (dict, np.ndarray)) for v in a.values()):
            if a != b:
                raise AssertionError(f"{what}: values differ")
            return
        for k in a:
            _snapshots_equal(f"{what}[{k!r}]", a[k], b[k])
    elif isinstance(a, np.ndarray):
        if not (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b)):
            raise AssertionError(f"{what}: arrays differ")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


async def chain_at_size(pkg, card: str, tmp: str) -> None:
    """A ``BucketStoreServer(snapshot_incremental=True)`` over a card store
    of 2^24 slots holding 2M bucket keys, 1M sliding-window keys, 2^16
    counters and 2^16 held semaphores: a base, a delta of 510,000 slots, an
    empty delta, and the save after a day's sweep; the chain restored into
    fresh card stores equals the saving store."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    def card_store(clock):
        return pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                     counter_slots=2 * CKPT_COUNTERS,
                                     clock=clock)

    path = os.path.join(tmp, "chain.snap")
    clock = pkg.ManualClock(1_000_000)
    store = card_store(clock)
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0,
                                   snapshot_path=path,
                                   snapshot_incremental=True)
    addr = await server.start()
    cli = pkg.RemoteBucketStore(address=addr, request_timeout_s=900.0)
    t0 = time.perf_counter()
    for pos in range(0, CKPT_CHAIN_KEYS, CKPT_FILL_CALL):
        keys = [f"ck{i}" for i in range(pos, min(pos + CKPT_FILL_CALL,
                                                 CKPT_CHAIN_KEYS))]
        res = await store.acquire_many(keys, [1] * len(keys), CKPT_LIMIT,
                                       CKPT_RATE, with_remaining=False)
        if res.granted_count != len(keys):
            raise AssertionError("chain fill: a fresh key was denied")
    wkeys = [f"cw{i}" for i in range(CKPT_WINDOW_KEYS)]
    await store.window_acquire_many(wkeys, [1] * len(wkeys), WINDOW_LIMIT,
                                    1.0)
    ckeys = [f"cc{i}" for i in range(CKPT_COUNTERS)]
    await store.sync_counters_many(ckeys, [1.0] * CKPT_COUNTERS,
                                   DECAY_PER_S)
    skeys = [f"cs{i}" for i in range(CKPT_SEMAS)]
    res = await store.concurrency_acquire_many(skeys, [1] * CKPT_SEMAS, 5)
    if not res.granted.all():
        raise AssertionError("chain fill: a semaphore was refused")
    drained = await asyncio.gather(*(store.acquire("five", 1, 5.0, 1.0)
                                     for _ in range(5)))
    if not all(r.granted for r in drained):
        raise AssertionError("chain fill: the cap-5 key did not drain")
    fill_s = time.perf_counter() - t0
    timer = store._lock = _HoldTimer(store._lock)
    saves = []

    async def save(label):
        timer.longest = 0.0
        t = time.perf_counter()
        await cli.save()
        wall, hold = time.perf_counter() - t, timer.longest
        st = (await cli.stats())["snapshot_chain"]
        kind = "delta" if st["chain_len"] else "full base"
        nbytes = (st["last_delta_bytes"] if st["chain_len"]
                  else st["base_bytes"])
        saves.append((label, kind, wall, nbytes, hold))
        return st

    st = await save("base")
    base_bytes = st["base_bytes"]
    # Delta 1: 500,000 of the keys again and 10,000 new ones.
    again = [f"ck{i}" for i in range(0, CKPT_CHAIN_KEYS,
                                     CKPT_CHAIN_KEYS // CKPT_REACQUIRE)]
    new = [f"cn{i}" for i in range(CKPT_NEW_KEYS)]
    clock.advance_ticks(512)
    for keys in (again, new):
        await store.acquire_many(keys, [1] * len(keys), CKPT_LIMIT,
                                 CKPT_RATE, with_remaining=False)
    dirty1 = store.dirty_stats()
    if dirty1["dirty"] != CKPT_REACQUIRE + CKPT_NEW_KEYS:
        raise AssertionError(f"dirty before delta 1: {dirty1}")
    st = await save("delta 1")
    if st["chain_len"] != 1 or st["last_delta_bytes"] * 10 >= base_bytes:
        raise AssertionError(f"delta 1: {st}")
    dirty2 = store.dirty_stats()
    if dirty2["dirty"] != 0:
        raise AssertionError(f"dirty before delta 2: {dirty2}")
    st = await save("delta 2 (empty)")
    if st["chain_len"] != 2:
        raise AssertionError(f"delta 2: {st}")
    # Restore base + 2 deltas into a fresh card store at the save's tick.
    t = time.perf_counter()
    fresh = card_store(pkg.ManualClock(clock.now_ticks()))
    n_deltas = checkpoint.load_snapshot_chain(fresh, path)
    load_s = time.perf_counter() - t
    # The saving store's snapshot at delta 2, kept by the chain as the next
    # diff's base (nothing wrote since): one full pull fewer.
    t = time.perf_counter()
    _snapshots_equal("chain restore", fresh.snapshot(),
                     server._snapshot_chain._prev_snap)
    compare_s = time.perf_counter() - t
    if n_deltas != 2:
        raise AssertionError(f"chain restore applied {n_deltas} deltas")
    if fresh.peek_blocking("five", 5.0, 1.0) != 0.0:
        raise AssertionError("restored cap-5 key is not drained")
    fresh.clock.advance_seconds(5.0)
    res = await asyncio.gather(*(fresh.acquire("five", 1, 5.0, 1.0)
                                 for _ in range(32)))
    if sum(r.granted for r in res) != 5:
        raise AssertionError("restored cap-5 key: not 5 of 32")
    # A key of the fill, full again after the 5.5 s since it took 1.
    one = fresh.acquire_blocking("ck1", 1, CKPT_LIMIT, CKPT_RATE)
    if not (one.granted and one.remaining == CKPT_LIMIT - 1):
        raise AssertionError(f"restored key ck1: {one}")
    await fresh.aclose()
    del fresh
    # A day later: the sweep evicts every bucket, window and counter.
    clock.advance_seconds(86_400)
    t = time.perf_counter()
    store.sweep_all()
    sweep_s = time.perf_counter() - t
    st = await save("after sweep_all")
    after = saves[-1][1]
    fresh = card_store(pkg.ManualClock(clock.now_ticks()))
    n_after = checkpoint.load_snapshot_chain(fresh, path)
    _snapshots_equal("chain restore after the sweep", fresh.snapshot(),
                     store.snapshot())
    if n_after != (3 if after == "delta" else 0):
        raise AssertionError(f"after the sweep: {n_after} deltas")
    held = fresh.snapshot()["semas"]["active"].sum()
    await fresh.aclose()
    stats = await cli.stats()
    await cli.aclose()
    await server.aclose()
    await store.aclose()
    print(f"checkpoint chain ({card}): {CKPT_CHAIN_KEYS} bucket keys, "
          f"{CKPT_WINDOW_KEYS} sliding-window keys, {CKPT_COUNTERS} counters,"
          f" {CKPT_SEMAS} held semaphores on {N_SLOTS} slots, filled in "
          f"{fill_s:.1f} s; dirty before delta 1 {dirty1}, before delta 2 "
          f"{dirty2}; saves (OP_SAVE wall s, bytes, the store lock's longest "
          "hold s): " + "; ".join(
              f"{lbl}: {kind} {wall:.2f} s {nb} B lock {hold:.3f} s"
              for lbl, kind, wall, nb, hold in saves)
          + f"; delta 1 / base {saves[1][3] / base_bytes:.4f}; restore of "
          f"base + {n_deltas} deltas {load_s:.2f} s, equal to the saving "
          f"store (compared in {compare_s:.2f} s), cap-5 x 32 -> 5 on the "
          f"restored drained key after 5 s; sweep_all {sweep_s:.2f} s, then "
          f"a {after} (restored equal, {int(held)} permits held); OP_STATS "
          f"snapshot_chain {stats['snapshot_chain']}")


def console_chain(pkg, tmp: str) -> None:
    """The console entry point with ``--snapshot-incremental``: on the
    serial backend (ping, cap-5 x 32 -> 5, OP_SAVE twice, SIGTERM -> exit
    0), and on the card, restarted on the chain it left (``(+N deltas)``)."""
    import select
    import signal

    root = os.path.dirname(os.path.abspath(__file__))

    def start(args):
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributedratelimiting.redis_tpu_torch.runtime.server",
             "--port", "0", *args], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        lines = []
        while True:
            ready, _, _ = select.select([proc.stdout], [], [], 120)
            line = proc.stdout.readline() if ready else ""
            if line.startswith("bucket-store server listening on "):
                host, port = line.split()[-1].rsplit(":", 1)
                return proc, (host, int(port)), lines
            if not line:
                proc.kill()
                raise AssertionError(
                    f"console server {args}: {lines}; stderr "
                    f"{proc.communicate()[1][-2000:]!r}")
            lines.append(line.strip())

    def stop(proc):
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        if proc.returncode != 0 or "final checkpoint" not in out:
            raise AssertionError(f"console server: rc {proc.returncode} "
                                 f"{out[-500:]!r} {err[-2000:]!r}")

    async def drive(addr, key, saves, want):
        cli = pkg.RemoteBucketStore(address=addr)
        await cli.ping()
        await cli.acquire_many([f"bulk{i}" for i in range(2000)],
                               [1] * 2000, 10.0, 1e-6)
        res = await asyncio.gather(*(cli.acquire(key, 1, 5.0, 1e-6)
                                     for _ in range(32)))
        for _ in range(saves):
            await cli.save()
        stats = await cli.stats()
        await cli.aclose()
        if sum(r.granted for r in res) != want:
            raise AssertionError(f"console {key}: not {want} of 32")
        return stats["snapshot_chain"]

    out = []
    for backend, extra in (("inprocess", []),
                           ("device", ["--slots", "1048576",
                                       *CLI_EXTRA_ARGS])):
        path = os.path.join(tmp, f"console-{backend}.snap")
        args = ["--backend", backend, "--snapshot-path", path,
                "--snapshot-incremental", *extra]
        t = time.perf_counter()
        proc, addr, _ = start(args)
        try:
            chain = asyncio.run(drive(addr, "five", 2, 5))
            stop(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        links = sorted(q for q in os.listdir(tmp)
                       if q.startswith(f"console-{backend}.snap"))
        msg = (f"--backend {backend} --snapshot-incremental: cap-5 x 32 -> "
               f"5, OP_SAVE x2 ({chain['full_saves']} full, "
               f"{chain['delta_saves']} delta), SIGTERM -> exit 0, files "
               f"{links}")
        if backend == "device":
            proc, addr, lines = start(args)
            try:
                # The restored key holds what it had: none of 32 granted.
                asyncio.run(drive(addr, "five", 0, 0))
                stop(proc)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if not any("deltas)" in ln for ln in lines):
                raise AssertionError(f"console restart: {lines}")
            msg += f"; restarted: {lines[-1]!r}, cap-5 x 32 -> 0"
        out.append(f"{msg} ({time.perf_counter() - t:.1f} s)")
    print("console chain: " + " | ".join(out))


async def checkpoint_path(torch, ck, pkg, card: str) -> dict:
    """The serial store and incremental checkpoints on the card: the serial
    oracle, the chain at the main path's size, the console entry point with
    ``--snapshot-incremental`` on both backends, and the bench's child
    sections. Returns the kernel launches the path made."""
    import shutil
    import tempfile

    from distributedratelimiting.redis_tpu_torch import bench

    ck.reset_launches()
    walls = {}
    t = time.perf_counter()
    await serial_oracle(pkg, card)
    walls["oracle"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="drl-chain-")
    try:
        t = time.perf_counter()
        await chain_at_size(pkg, card, tmp)
        walls["chain"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        await asyncio.to_thread(console_chain, pkg, tmp)
        walls["console"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = torch.device("cuda")
    keys = dict(bench.SECTIONS)
    values = {}
    for name in ("nproc", "serving_p99_colocated", "serving_p99_instant"):
        t = time.perf_counter()
        if name == "nproc":
            vals = await bench.bench_nproc(dev, **CKPT_BENCH[name])
        else:
            vals = await asyncio.to_thread(
                bench.serving_section, dev,
                "device" if name.endswith("colocated") else "instant",
                **CKPT_BENCH[name])
        walls[name] = time.perf_counter() - t
        values.update(zip(keys[name], vals, strict=True))
    nulls = [k for k, v in values.items() if v is None]
    if nulls:
        raise AssertionError(f"bench sections: null keys {nulls}")
    p99 = values["serving_p99_colocated_ms"] - values["serving_p99_instant_ms"]
    print(f"bench child sections ({card}; short windows {CKPT_BENCH}): "
          + json.dumps(values) + f"; colocated - instant p99 at depth 64: "
          f"{p99:.3f} ms")
    print("checkpoint path walls (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))
    return dict(ck.launches)


OBS_SEED = 1515
#: The client process's traffic: Zipf(1.1) over 1M keys, 50,000
#: ``acquire``s one frame each, 64 tasks (the server cell's scalar shape;
#: 100,000 until the drain path joined the script, whose 1,200 s limit a
#: slow host's run passed at 1,227 s).
OBS_ZIPF_KEYS = 1_000_000
OBS_REQUESTS = 50_000
OBS_TASKS = 64
#: The heavy-hitter sketch's K (the server's default) and the traced
#: window's requests.
OBS_TOP = 64
OBS_TRACED = 200
#: The device trace's bulk, and its store's device.
OBS_TRACE_KEYS = 1_000_000
OBS_TRACE_DEVICE = "cuda"
#: The plane's cost: the same 50,000 requests split over ABBA blocks of
#: windows (on, off, off, on), each window this many requests (12,500
#: until the drain path joined the script).
OBS_COST_BLOCKS = 2
OBS_COST_WINDOW = 6_250
#: A bucket no traffic here exhausts: every scalar request is granted.
OBS_CAP, OBS_RATE = 1e9, 1e9
#: The chaos phase's storm (``utils/faults.storm_schedule``).
OBS_STORM_SEED = 24
OBS_STORM_REQUESTS = 200


def _obs_zipf(n: int, n_keys: int, seed: int) -> np.ndarray:
    """``n`` seeded Zipf(1.1) key ids in ``[0, n_keys)`` (rejection of the
    tail past ``n_keys``, so the head's shares are Zipf's)."""
    rng = np.random.default_rng(seed)
    out = np.empty(0, np.int64)
    while len(out) < n:
        d = rng.zipf(ZIPF_S, 2 * n)
        out = np.concatenate([out, d[d <= n_keys] - 1])
    return out[:n]


async def _obs_window(store, keys, workers: int) -> tuple:
    """Closed-loop per-request ``acquire``s of ``keys`` by ``workers``
    tasks: (requests/s, per-request latencies in s, grants)."""
    it = iter(keys)
    lat: list = []
    granted = [0]

    async def worker():
        for k in it:
            t = time.perf_counter()
            res = await store.acquire(k, 1, OBS_CAP, OBS_RATE)
            lat.append(time.perf_counter() - t)
            granted[0] += res.granted

    t0 = time.perf_counter()
    await asyncio.gather(*(worker() for _ in range(workers)))
    return len(keys) / (time.perf_counter() - t0), lat, granted[0]


async def obs_client(pkg, host: str, ports: list, mode: str, n: int,
                     n_keys: int, window: int) -> dict:
    """The observability path's client process (``python3 chip_smoke.py
    --obs-client HOST PORT[,PORT] zipf|cost N NKEYS WINDOW``): ``zipf``
    sends the seeded Zipf(1.1) traffic (``N`` requests over ``NKEYS`` keys)
    to one server; ``cost`` sends uniform requests to two servers (plane
    on, plane off) in ABBA blocks of ``WINDOW``-request windows. One frame
    a request, 64 tasks."""
    stores = [pkg.RemoteBucketStore(address=(host, p),
                                    coalesce_requests=False,
                                    request_timeout_s=120.0) for p in ports]
    try:
        if mode == "zipf":
            ids = _obs_zipf(n, n_keys, OBS_SEED)
            rate, lat, granted = await _obs_window(
                stores[0], [f"z{i}" for i in ids.tolist()], OBS_TASKS)
            return {"requests": len(ids), "granted": granted,
                    "rate": rate, "p50_ms": _pct(lat, 50) * 1e3,
                    "p99_ms": _pct(lat, 99) * 1e3}
        rng = np.random.default_rng(OBS_SEED + 1)
        for st in stores:  # warm both sides (the off store's first table)
            await _obs_window(st, [f"c{i}" for i in rng.integers(
                0, n_keys, window // 5).tolist()], OBS_TASKS)
        sides = {"on": {"lat": [], "rates": []},
                 "off": {"lat": [], "rates": []}}
        blocks = []
        for _ in range(OBS_COST_BLOCKS):
            block = {}
            for side in ("on", "off", "off", "on"):
                keys = [f"c{i}" for i in rng.integers(
                    0, n_keys, window).tolist()]
                rate, lat, granted = await _obs_window(
                    stores[0 if side == "on" else 1], keys, OBS_TASKS)
                if granted != len(keys):
                    raise AssertionError(f"cost window ({side}): "
                                         f"{granted}/{len(keys)} granted")
                sides[side]["lat"] += lat
                sides[side]["rates"].append(rate)
                block.setdefault(side, []).append(rate)
            blocks.append({s: sum(r) / 2 for s, r in block.items()})
        out = {s: {"rates": v["rates"], "p50_ms": _pct(v["lat"], 50) * 1e3,
                   "p99_ms": _pct(v["lat"], 99) * 1e3,
                   "requests": len(v["lat"])} for s, v in sides.items()}
        out["blocks"] = blocks
        return out
    finally:
        for st in stores:
            await st.aclose()


async def _obs_run_client(host: str, ports: list, mode: str) -> dict:
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), "--obs-client", host,
        ",".join(map(str, ports)), mode, str(OBS_REQUESTS),
        str(OBS_ZIPF_KEYS), str(OBS_COST_WINDOW),
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 600)
    finally:
        if proc.returncode is None:
            proc.kill()
            await asyncio.wait_for(proc.wait(), 30)
    if proc.returncode != 0:
        raise AssertionError(f"observability client ({mode}) exited "
                             f"{proc.returncode}: {err.decode()[-3000:]}")
    return json.loads(out.decode().strip().splitlines()[-1])


async def _obs_http(host: str, port: int, path: str,
                    accept: str = "") -> tuple:
    """One GET on the server's metrics listener: (status line, headers,
    body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        hdr = f"Accept: {accept}\r\n" if accept else ""
        writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n{hdr}\r\n"
                     .encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), 60)
    finally:
        writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    status, *headers = head.decode("latin-1").split("\r\n")
    return status, headers, body


def _obs_samples(text: str, metrics) -> dict:
    """``{(name, labels): value}`` of an OpenMetrics text."""
    _, samples = metrics.parse_openmetrics(text)
    return {(n, labels): v for n, labels, v in samples}


def _obs_hot_keys(samples: dict) -> dict:
    """The sketch's entries from the hot-key families: key → (count,
    error)."""
    out: dict = {}
    for (name, labels), v in samples.items():
        if name in ("drl_hot_key_count", "drl_hot_key_error"):
            key = dict(labels)["key"]
            c, e = out.get(key, (None, None))
            out[key] = (v, e) if name.endswith("count") else (c, v)
    return out


def _obs_check_heavy_hitters(samples: dict, stats: dict, ids) -> str:
    """The top 64 of ``OP_METRICS`` against the exact counts of the Zipf
    traffic (its keys' only feed): Space-Saving's ``count - error <= true``
    for every entry, ``true <= count`` and presence for every key above
    N/64; ``OP_STATS``'s top 10 is the head of the same list. The
    buffered feed merges each 1,024-request buffer's top 128 keys only (the
    JAX design, kept): a tail entry may miss some of its requests and read
    below its true count, and that is counted, not failed."""
    from collections import Counter

    true = Counter(f"z{i}" for i in ids.tolist())
    hot = _obs_hot_keys(samples)
    if len(hot) != OBS_TOP:
        raise AssertionError(f"heavy hitters: {len(hot)} entries, not "
                             f"{OBS_TOP}")
    bad_low = [(k, c, e, true.get(k, 0)) for k, (c, e) in hot.items()
               if c - e > true.get(k, 0)]
    if bad_low:
        raise AssertionError(f"heavy hitters: count - error above the true "
                             f"count {bad_low[:5]}")
    n = len(ids)
    heavy = [k for k, v in true.items() if v > n / OBS_TOP]
    missing = [k for k in heavy if k not in hot]
    over = [(k, hot[k][0], true[k]) for k in heavy
            if k in hot and true[k] > hot[k][0]]
    if missing or over or not heavy:
        raise AssertionError(f"heavy hitters: keys above N/{OBS_TOP} "
                             f"({len(heavy)}) missing {missing}, "
                             f"undercounted {over}")
    tail_under = [(k, c, true.get(k, 0)) for k, (c, e) in hot.items()
                  if true.get(k, 0) > c]
    top10 = [(t["key"], t["count"]) for t in stats["hot_keys"]["top"]]
    ranked = sorted(((k, c) for k, (c, _) in hot.items()),
                    key=lambda kc: -kc[1])
    if [c for _, c in top10] != [c for _, c in ranked[:10]] or any(
            hot[k][0] != c for k, c in top10):
        raise AssertionError(f"OP_STATS top 10 {top10} is not the head of "
                             f"the metrics' top {ranked[:10]}")
    return (f"{len(heavy)} keys above N/{OBS_TOP} all present with "
            f"count - error <= true <= count; all {OBS_TOP} entries "
            f"count - error <= true; {len(tail_under)} tail entries read "
            f"below their true count (by at most "
            f"{max([t - c for _, c, t in tail_under], default=0):.0f}: the "
            f"buffered feed's per-buffer top)")


def _obs_check_device_trace(path: str, scans: int) -> str:
    """The device trace holds ``drl/`` ranges, and every kernel in it was
    launched inside one: its CUDA runtime launch (matched by correlation
    id) lies within a ``drl/`` range of the launching thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("drl/")
              and e.get("cat") == "user_annotation"]
    if not ranges:
        raise AssertionError("device trace: no drl/ range")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    outside = []
    for k in kernels:
        rt = launch.get(k.get("args", {}).get("correlation"))
        if rt is None or not any(
                r["tid"] == rt["tid"] and r["ts"] <= rt["ts"]
                and rt["ts"] + rt.get("dur", 0) <= r["ts"] + r["dur"]
                for r in ranges):
            outside.append(k["name"][:60])
    scan_kernels = [k for k in kernels if "scan" in k["name"]]
    if outside or len(scan_kernels) < scans:
        from collections import Counter

        import torch

        cats = Counter(str(e.get("cat")) for e in events)
        free, total = torch.cuda.mem_get_info()
        raise AssertionError(f"device trace: {len(outside)} kernels "
                             f"launched outside a drl/ range {outside[:3]}; "
                             f"{len(scan_kernels)} scan kernels for {scans} "
                             f"acquire_scan launches; events by category "
                             f"{dict(cats)}; card memory free {free} of "
                             f"{total}, reserved "
                             f"{torch.cuda.memory_reserved()}")
    names = sorted({r["name"] for r in ranges})
    return (f"{len(ranges)} drl/ ranges {names}; {len(kernels)} kernels, "
            f"each launched inside one ({len(scan_kernels)} scans)")


async def obs_device_trace(pkg, device: str, n_slots: int, n_keys: int,
                           logdir: str) -> dict:
    """The observability path's device trace (``python3 chip_smoke.py
    --obs-device-trace DEVICE NSLOTS NKEYS DIR``): ``start_device_trace`` /
    ``stop_device_trace`` around an ``acquire_many`` of ``n_keys`` new keys
    on a card store, then :func:`_obs_check_device_trace`. A process of
    its own: in one that had taken the earlier paths' profiles, a later
    ``torch.profiler`` session recorded the CUDA runtime calls but no
    device activity (seen on the card; PERF.md §7), where a fresh process
    records both."""
    import torch

    from distributedratelimiting.redis_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from distributedratelimiting.redis_tpu_torch.utils import tracing

    store = pkg.DeviceBucketStore(device=device, n_slots=n_slots)
    lim = pkg.PartitionedRateLimiter(pkg.TokenBucketOptions(
        token_limit=100, tokens_per_period=10, replenishment_period_s=1.0,
        instance_name="obs-trace"), store)
    await lim.acquire_many(range(n_keys, n_keys + 1000), permits=1)  # warm
    scans0 = ck.launches["acquire_scan"]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    tracing.start_device_trace(logdir)
    try:
        t = time.perf_counter()
        res = await lim.acquire_many(range(n_keys), permits=1,
                                     with_remaining=False)
        if cuda:
            torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t
    finally:
        path = tracing.stop_device_trace()
    await store.aclose()
    if res.granted_count != n_keys:
        raise AssertionError("device-trace bulk: not every key granted")
    line = _obs_check_device_trace(path, ck.launches["acquire_scan"] - scans0)
    return {"line": line, "bulk_s": bulk_s, "bytes": os.path.getsize(path)}


async def _obs_leak_soak(pkg, seed: int) -> dict:
    """The JAX package's seeded leak soak (``tests/test_audit.py``
    ``_leak_soak``) on a card store: an ``audit.leak`` fault flips denies
    into granted replies with no store debit; one bundle within three
    ticks, exactly one after four more."""
    from distributedratelimiting.redis_tpu_torch.runtime.audit import (
        AuditConfig,
    )
    from distributedratelimiting.redis_tpu_torch.utils import faults, tracing
    from distributedratelimiting.redis_tpu_torch.utils.slo import SLOConfig

    tracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0,
                      latency_threshold_s=10.0)
    tracing.get_tracer().reset()
    srv = pkg.BucketStoreServer(
        pkg.DeviceBucketStore(device="cuda", n_slots=1 << 16),
        audit=AuditConfig(slo=SLOConfig(fast_ticks=2, slow_ticks=6,
                                        trip_streak=1, clear_streak=2)))
    await srv.start()
    srv._audit_task.cancel()  # the soak owns every tick
    try:
        await srv._audit_task
    except asyncio.CancelledError:
        pass
    srv._audit_task = None
    st = pkg.RemoteBucketStore(address=(srv.host, srv.port),
                               coalesce_requests=False)
    try:
        for i in range(30):
            await st.acquire(f"warm{i % 5}", 1, 1e6, 1e6)
        for _ in range(3):
            out = srv.auditor.tick()
            if out["breaches"] or out["alerts"]:
                raise AssertionError(f"leak soak warm-up alarmed: {out}")
        inj = faults.FaultInjector(seed, {"audit.leak": (
            faults.FaultRule(kind="error", probability=1.0),)})
        faults.install(inj)
        try:
            for _ in range(30):
                await st.acquire("hot", 50, 100.0, 0.0)
        finally:
            faults.uninstall()
        detect = None
        for i in range(3):
            out = srv.auditor.tick()
            if out["breaches"]:
                detect = i + 1
                if out["breaches"] != ["reply_witness"]:
                    raise AssertionError(f"leak soak: {out['breaches']}")
                break
        if detect is None:
            raise AssertionError("leak soak: no breach within 3 ticks")
        for _ in range(4):
            srv.auditor.tick()
        if srv.auditor.bundles_assembled != 1:
            raise AssertionError(f"leak soak: {srv.auditor.bundles_assembled}"
                                 " bundles, not 1")
        (bundle,) = srv.auditor.bundles
        snap = await st.audit(bundles=4)
        if [b["id"] for b in snap["bundles"]] != [bundle["id"]]:
            raise AssertionError("leak soak: OP_AUDIT ships another bundle")
        return {"injected": len(inj.events), "detect_ticks": detect,
                "bundle": bundle["id"], "reasons": bundle["reasons"],
                "residue": bundle["residues"]["reply_witness"],
                "alerts": len(srv.auditor.watchdog.alert_log)}
    finally:
        await st.aclose()
        await srv.aclose()
        await srv.store.aclose()
        tracing.configure(enabled=False)
        tracing.get_tracer().reset()


async def _obs_gates(pkg, server, addr) -> str:
    """Armed doomed-work and retry-shed gates and the overflow-pool
    redirect, by raw frames: JAX's words, and the store untouched."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    key, cap, rate = "gate-key", 5.0, 1e-9

    def peek():
        return server.store.peek_blocking(key, cap, rate)

    await _raw_request(addr, wire.encode_request(1, wire.OP_ACQUIRE, key, 1,
                                                 cap, rate))
    before = await asyncio.to_thread(peek)
    # A budget past the frame's wait in the server (tens of µs) and under
    # its serving p99: the doomed gate's case, not the plain deadline shed.
    p99 = server.serving_latency.p99
    if p99 < 2e-3:
        raise AssertionError(f"gates: serving p99 {p99 * 1e3:.3f} ms too "
                             "short to find a doomed budget under it")
    ddl = p99 / 2
    server.set_doomed_gate(True)
    server.set_retry_shed(True)
    try:
        answers = []
        for seq, kw in ((2, {"deadline_s": ddl}), (3, {"attempt": 1}),
                        (4, {"deadline_s": ddl, "attempt": 2})):
            _, kind, vals = await _raw_request(addr, wire.encode_request(
                seq, wire.OP_ACQUIRE, key, 1, cap, rate, **kw))
            answers.append((kind, vals[0]))
        resv = []
        for seq, extra in ((5, {"attempt": 1}), (6, {"deadline_s": ddl})):
            req = {"rid": f"gate-r{seq}", "tenant": "gate-t", "key": key,
                   "estimate": 2, "a": cap, "b": rate, "ta": 50.0,
                   "tb": rate, **extra}
            _, kind, vals = await _raw_request(addr, wire.encode_request(
                seq, wire.OP_RESERVE, json.dumps(req)))
            resv.append(json.loads(vals[0]))
    finally:
        server.set_doomed_gate(False)
        server.set_retry_shed(False)
    after = await asyncio.to_thread(peek)
    if after != before:
        raise AssertionError(f"gates: the store moved {before} -> {after}")
    (k1, doomed), (k2, shed), (k3, both) = answers
    if not (k1 == k2 == k3 == wire.RESP_ERROR
            and doomed.startswith(f"doomed: {ddl * 1e3:.1f}ms budget "
                                  "cannot cover p99 ")
            and doomed.endswith("ms at admit (shed unexecuted)")
            and shed == ("retry shed: attempt 1 denied while the "
                         "retry-storm defense is armed")
            and both.startswith("doomed: ")):
        raise AssertionError(f"gates: answers {answers}")
    if [r.get("shed") for r in resv] != ["retry", "doomed"] or any(
            r["granted"] for r in resv):
        raise AssertionError(f"gates: reserve answers {resv}")
    # The overflow-pool redirect: an interactive reserve whose estimate the
    # tenant's balance cannot cover within its deadline.
    req = {"rid": "gate-route", "tenant": "gate-t", "key": key,
           "estimate": 500, "a": cap, "b": rate, "ta": 50.0, "tb": rate,
           "priority": 0, "deadline_s": 1.0}
    _, kind, vals = await _raw_request(addr, wire.encode_request(
        7, wire.OP_RESERVE, json.dumps(req)))
    route = vals[0]
    if kind != wire.RESP_ERROR or not route.startswith("route-to-pool ") \
            or json.loads(route[len("route-to-pool "):]) != \
            server.overflow_pool:
        raise AssertionError(f"gates: overflow redirect {kind} {route}")
    return (f"doomed '{doomed}'; retry-shed '{shed}'; reserve answers "
            f"{[r['shed'] for r in resv]}; redirect '{route}'; store "
            f"{before} before and after")


async def _obs_chaos(pkg, server, addr) -> str:
    """A seeded storm on the client's and the server's seams: cap-5 x 32
    -> 5, and the storm's reserves (every retry under its rid) and their
    settles, retried, debit each rid once."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire
    from distributedratelimiting.redis_tpu_torch.utils import faults

    rules = {
        "server.dispatch": (
            faults.FaultRule(kind="delay", probability=0.3, delay_s=0.001,
                             jitter_s=0.003),
            faults.FaultRule(kind="error", probability=0.05)),
        "client.connect": (faults.FaultRule(kind="reset", probability=1.0,
                                            max_faults=1),),
        "client.write": (faults.FaultRule(kind="reset", probability=0.05,
                                          after=40, max_faults=4),),
    }
    storm = faults.storm_schedule(OBS_STORM_SEED,
                                  n_requests=OBS_STORM_REQUESTS)
    tenants = sorted({e.tenant for e in storm})
    cli = pkg.RemoteBucketStore(address=addr, coalesce_requests=False)
    inj = faults.FaultInjector(OBS_STORM_SEED, rules)
    faults.install(inj)
    try:
        outs = await asyncio.gather(*(cli.acquire("chaos-cap5", 1, 5.0, 1e-9)
                                      for _ in range(32)),
                                    return_exceptions=True)
        granted: dict = {}
        errors = 0
        for e in storm:
            try:
                res = await cli.reserve(e.rid, e.tenant, "storm-key",
                                        float(e.cost), 1e6, 1e-9, 1e5, 1e-9,
                                        attempt=e.attempt)
            except wire.RemoteStoreError:
                errors += 1
                continue
            if res.granted and not res.duplicate:
                if e.rid in granted:
                    raise AssertionError(f"storm: {e.rid} held twice")
                granted[e.rid] = (e.tenant, e.cost)
    finally:
        faults.uninstall()
    decided = [o for o in outs if not isinstance(o, BaseException)]
    if sum(o.granted for o in decided) != 5 or len(decided) < 5:
        raise AssertionError(f"chaos cap-5: {sum(o.granted for o in decided)}"
                             f" granted of {len(decided)} decided")
    # Each stream spent one token over its estimate: the settle debits the
    # overage once, its retry answers the recorded result.
    for rid, (tenant, cost) in granted.items():
        for i in range(2):
            res = await cli.settle(rid, tenant, float(cost + 1))
            if res.outcome != ("settled", "duplicate")[i]:
                raise AssertionError(f"storm settle {rid}: {res}")
    spent = {t: sum(c + 1 for tt, c in granted.values() if tt == t)
             for t in tenants}
    bal = {t: await asyncio.to_thread(server.store.peek_blocking, t, 1e6,
                                      1e-9) for t in tenants}
    if any(bal[t] != 1e6 - spent[t] for t in tenants):
        raise AssertionError(f"storm: tenant balances {bal}, spent {spent}")
    stats = cli.resilience_stats()
    await cli.aclose()
    kinds: dict = {}
    for ev in inj.events:
        kinds[f"{ev.seam}:{ev.kind}"] = kinds.get(f"{ev.seam}:{ev.kind}",
                                                  0) + 1
    return (f"cap-5 x 32: 5 granted of {len(decided)} decided "
            f"({32 - len(decided)} failed by injected faults); storm seed "
            f"{OBS_STORM_SEED}: {len(storm)} attempts of "
            f"{OBS_STORM_REQUESTS} requests, {len(granted)} rids held once, "
            f"{errors} attempts failed, settled twice each, tenant balances "
            f"exact; faults {kinds}; client retries {stats['retries']}")


async def observability_path(torch, ck, pkg, card: str) -> dict:
    """The server's observability and overload plane on the card, at the
    server cell's size. Returns the kernel launches the path made."""
    import shutil
    import tempfile
    from collections import Counter

    from distributedratelimiting.redis_tpu_torch.runtime.audit import (
        AuditConfig,
    )
    from distributedratelimiting.redis_tpu_torch.utils import (
        faults,
        tracing,
    )
    from distributedratelimiting.redis_tpu_torch.utils import (
        metrics as M,
    )

    flight_dir = tempfile.mkdtemp(prefix="drl-flight-")
    pool = {"pool": "batch", "ta": 500.0, "tb": 5.0, "priority": 1}
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  max_batch=BATCH)
    server = pkg.BucketStoreServer(
        store, host="127.0.0.1", port=0, observability=True,
        metrics_port=0, flight_dir=flight_dir,
        audit=AuditConfig(tick_s=0.05), overflow_pool=pool)
    store_off = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                      max_batch=BATCH)
    server_off = pkg.BucketStoreServer(store_off, host="127.0.0.1", port=0,
                                       observability=False)
    host, port = await server.start()
    _, port_off = await server_off.start()
    addr = (host, port)
    cli = pkg.RemoteBucketStore(address=addr, request_timeout_s=600.0)
    walls: dict = {}
    ck.reset_launches()
    try:
        # 1. The client process's Zipf traffic, then the 10M-key bulk as
        # ACQUIRE_MANY frames, /metrics scraped all the while. The sketch
        # is checked between them: the bulk lane feeds it too (sampled
        # weights), so the exact counts are the Zipf stream's alone.
        t = time.perf_counter()
        served0 = server.requests_served
        scrapes: list = []
        done = asyncio.Event()

        async def scraper():
            while not done.is_set():
                s0 = time.perf_counter()
                status, _, body = await _obs_http(
                    host, server.metrics_port, "/metrics",
                    "application/openmetrics-text")
                if not status.endswith("200 OK") or not body.endswith(
                        b"# EOF\n"):
                    raise AssertionError(f"/metrics: {status}")
                M.parse_openmetrics(body.decode())
                scrapes.append((time.perf_counter() - s0, len(body)))
                await asyncio.sleep(0.5)

        scrape_task = asyncio.ensure_future(scraper())
        try:
            zipf = await _obs_run_client(host, [port], "zipf")
            walls["zipf traffic"] = time.perf_counter() - t
            if zipf["granted"] != OBS_REQUESTS:
                raise AssertionError(f"zipf traffic: {zipf}")
            ids = _obs_zipf(OBS_REQUESTS, OBS_ZIPF_KEYS, OBS_SEED)
            stats = await cli.stats()
            hh_text = await cli.metrics()
            hh_line = _obs_check_heavy_hitters(_obs_samples(hh_text, M),
                                               stats, ids)
            t = time.perf_counter()
            lim = pkg.PartitionedRateLimiter(pkg.TokenBucketOptions(
                token_limit=100, tokens_per_period=10,
                replenishment_period_s=1.0, instance_name="obs"), cli)
            res = await lim.acquire_many(range(N_KEYS), permits=1,
                                         with_remaining=False)
            if res.granted_count != N_KEYS:
                raise AssertionError("observability bulk: not every key "
                                     "granted")
            walls["bulk"] = time.perf_counter() - t
        finally:
            done.set()
            await scrape_task
        if not scrapes:
            raise AssertionError("no /metrics scrape during the traffic")
        text = await cli.metrics()
        served = server.requests_served
        want = {
            ("drl_requests_served_total", ()): served - 1,
            ("drl_connections_served_total", ()): server.connections_served,
            ("drl_requests_shed_total", ()): server.requests_shed,
            ("drl_store_launches_total", ()): store.metrics.launches,
            ("drl_store_rows_valid_total", ()): store.metrics.rows_valid,
            ("drl_retry_attempts_seen_total", ()):
                server.retry_attempts_seen,
            ("drl_hot_keys_offered", ()): server.heavy_hitters.offered,
            ("drl_serving_latency_seconds_count", ()):
                server.serving_latency.total - 1,
        }
        samples = _obs_samples(text, M)
        off = {k: (samples.get(k), v) for k, v in want.items()
               if samples.get(k) != v}
        if off or served - served0 < OBS_REQUESTS:
            raise AssertionError(f"OP_METRICS disagrees with the server: "
                                 f"{off}; served {served - served0}")
        print(f"observability zipf traffic ({card}): {OBS_REQUESTS} "
              f"acquires over {OBS_ZIPF_KEYS} keys, {OBS_TASKS} tasks, one "
              f"frame each: {zipf['rate']:.0f} requests/s, client p50 "
              f"{zipf['p50_ms']:.3f} ms, p99 {zipf['p99_ms']:.3f} ms; then "
              f"{N_KEYS} keys as ACQUIRE_MANY frames in {walls['bulk']:.3f} "
              f"s = {N_KEYS / walls['bulk']:.0f} decisions/s; "
              f"{len(scrapes)} /metrics scrapes meanwhile, median "
              f"{statistics.median(s for s, _ in scrapes) * 1e3:.1f} ms, "
              f"last {scrapes[-1][1]} bytes; OP_METRICS equals the server's "
              f"counters ({len(samples)} samples)")
        print(f"observability heavy hitters: {hh_line}; top 3 "
              f"{[(t['key'], t['count'], t['error']) for t in stats['hot_keys']['top'][:3]]}"
              f" (exact {Counter(ids.tolist()).most_common(3)})")

        # 3. Traces: sample 1.0 for a short window.
        t = time.perf_counter()
        tracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0)
        tracing.get_tracer().reset()
        solo = pkg.RemoteBucketStore(address=addr, coalesce_requests=False)
        try:
            await asyncio.gather(*(solo.acquire(f"traced{i % 16}", 1, OBS_CAP,
                                                OBS_RATE)
                                   for i in range(OBS_TRACED)))
            chrome = await solo.traces(drain=True)
        finally:
            tracing.configure(enabled=False)
            tracing.get_tracer().reset()
            await solo.aclose()
        spans = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
        by_trace: dict = {}
        for e in spans:
            by_trace.setdefault(e["args"]["trace_id"], set()).add(
                e["name"].split(".")[0])
        server_traces = [k for k, v in by_trace.items() if "server" in v]
        if len(server_traces) < OBS_TRACED or any(
                "client" not in by_trace[k] for k in server_traces):
            raise AssertionError(f"traces: {len(server_traces)} traces with "
                                 "server spans, or one without its client's")
        walls["traces"] = time.perf_counter() - t
        print(f"observability traces: OP_TRACES Chrome JSON, {len(spans)} "
              f"spans in {len(by_trace)} traces; {len(server_traces)} carry "
              f"server.* spans, each under its client's trace id "
              f"({sorted({e['name'] for e in spans})})")

        # 4. A device trace around a 1M-key bulk, in a process of its own
        # (see obs_device_trace).
        t = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, os.path.abspath(__file__), "--obs-device-trace",
            OBS_TRACE_DEVICE, str(N_SLOTS), str(OBS_TRACE_KEYS), flight_dir,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        try:
            out, err = await asyncio.wait_for(proc.communicate(), 300)
        finally:
            if proc.returncode is None:
                proc.kill()
                await asyncio.wait_for(proc.wait(), 30)
        if proc.returncode != 0:
            raise AssertionError(f"device trace process exited "
                                 f"{proc.returncode}: {err.decode()[-3000:]}")
        dt = json.loads(out.decode().strip().splitlines()[-1])
        walls["device trace"] = time.perf_counter() - t
        print(f"observability device trace ({card}; a process of its own): "
              f"{OBS_TRACE_KEYS} keys in {dt['bulk_s']:.3f} s under the "
              f"profiler; {dt['line']}; {dt['bytes']} bytes")

        # 5. One forced flush failure through the store.flush seam.
        t = time.perf_counter()
        for f in os.listdir(flight_dir):
            if f.endswith(".jsonl"):
                raise AssertionError(f"flight dump before the fault: {f}")
        faults.install(faults.FaultInjector(OBS_SEED, {"store.flush": (
            faults.FaultRule(kind="error", probability=1.0,
                             max_faults=1),)}))
        solo = pkg.RemoteBucketStore(address=addr, coalesce_requests=False)
        try:
            outs = await asyncio.gather(*(solo.acquire(f"flush{i}", 1, OBS_CAP,
                                                       OBS_RATE)
                                          for i in range(16)),
                                        return_exceptions=True)
            for i in range(8):  # healthy again
                await solo.acquire(f"after{i}", 1, OBS_CAP, OBS_RATE)
        finally:
            faults.uninstall()
            await solo.aclose()
        failed = [o for o in outs if isinstance(o, BaseException)]
        dumps = [f for f in os.listdir(flight_dir) if f.endswith(".jsonl")]
        if len(dumps) != 1 or "flush_error" not in dumps[0] or not failed:
            raise AssertionError(f"flight recorder: dumps {dumps}, "
                                 f"{len(failed)} failed requests")
        with open(os.path.join(flight_dir, dumps[0])) as f:
            header, *frames = [json.loads(line) for line in f]
        flushes = [fr for fr in frames if fr["kind"] == "flush"]
        bad = [fr for fr in flushes if fr["error"]]
        if (header["reason"] != "flush_error" or len(bad) != 1
                or bad[0]["n"] != len(failed)
                or "store.flush" not in header["error"]):
            raise AssertionError(f"flight dump: {header}, {bad}")
        status, _, body = await _obs_http(host, server.metrics_port,
                                          "/flight")
        walls["flight"] = time.perf_counter() - t
        print(f"observability flight recorder: one injected flush failure "
              f"({len(failed)} requests failed) gave exactly one "
              f"flush_error dump of {len(frames)} frames ({len(flushes)} "
              f"flushes, the failed one n={bad[0]['n']}); /flight within "
              f"the rate limit: {body.decode()}")

        # 6. The audit: clean so far, 20 ticks and more; then the leak soak.
        t = time.perf_counter()
        while server.auditor.ticks < 20:
            await asyncio.sleep(0.05)
        audit = await cli.audit()
        if audit["breaches"] or audit["tick_failures"] or audit["bundle_ids"]:
            raise AssertionError(f"clean traffic audit: {audit}")
        soak = await _obs_leak_soak(pkg, OBS_SEED)
        walls["audit"] = time.perf_counter() - t
        print(f"observability audit: clean traffic {audit['ticks']} ticks, "
              f"0 breaches, residues {audit['residues']}; leak soak on a "
              f"card store: {soak}")

        # 7. The overload gates and the overflow-pool redirect.
        t = time.perf_counter()
        gates = await _obs_gates(pkg, server, addr)
        walls["gates"] = time.perf_counter() - t
        print(f"observability gates: {gates}")

        # 8. Chaos: a seeded storm on both sides' seams.
        t = time.perf_counter()
        chaos = await _obs_chaos(pkg, server, addr)
        walls["chaos"] = time.perf_counter() - t
        print(f"observability chaos: {chaos}")

        # 9. The plane's cost: the same requests, plane on and off, ABBA.
        t = time.perf_counter()
        await cli.stats(reset=True)
        off_cli = pkg.RemoteBucketStore(address=(host, port_off))
        await off_cli.stats(reset=True)
        cost = await _obs_run_client(host, [port, port_off], "cost")
        on_stats = await cli.stats()
        off_stats = await off_cli.stats()
        await off_cli.aclose()
        walls["cost"] = time.perf_counter() - t
        deltas = sorted((b["off"] - b["on"]) / b["off"]
                        for b in cost["blocks"])
        print(f"observability cost ({card}; {OBS_COST_BLOCKS} ABBA blocks "
              f"of {OBS_COST_WINDOW}-request windows, {OBS_TASKS} tasks, one "
              f"frame each): on {statistics.mean(cost['on']['rates']):.0f} "
              f"requests/s, client p99 {cost['on']['p99_ms']:.3f} ms, server "
              f"p99 {on_stats['serving_p99_ms']:.3f} ms; off "
              f"{statistics.mean(cost['off']['rates']):.0f} requests/s, "
              f"client p99 {cost['off']['p99_ms']:.3f} ms, server p99 "
              f"{off_stats['serving_p99_ms']:.3f} ms; paired block deltas "
              f"{[round(d * 100, 2) for d in deltas]} % (not asserted)")
    finally:
        await cli.aclose()
        await server.aclose()
        await server_off.aclose()
        await store.aclose()
        await store_off.aclose()
        shutil.rmtree(flight_dir, ignore_errors=True)
    print("observability path walls (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))
    return dict(ck.launches)


#: The bench's shapes (``redis_tpu_torch/bench.py``): a 10M-slot table, K =
#: 32 batches of 8192 in the 3-byte operand (two scan launches), K = 16 in
#: the 5-byte operand (one), and one batch of 8192 for ``acquire_batch``.
BENCH_N_SLOTS = 10_000_000
BENCH_BATCH = 8192
BENCH_SCAN_K = 32
BENCH_COMPACT_K = 16
#: Timed dispatches of each bench section on the bench path (one window).
BENCH_ITERS = 5
#: The smaller widths ``acquire_batch`` is held at, with Zipf repeats, and
#: timed beside the flush the store would take at them (prefix 0).
BENCH_SMALL_B = (8, 64)


def _check_within_adds(what, slots, got, want) -> float:
    """Tokens after ``acquire_batch`` without the duplicate serialization: a
    slot's rows all decide from its refilled balance; the kernel subtracts
    their int64 consumption once, the plain version row by row, so a
    balance driven far below zero may round differently. Each slot within
    r float32 spacings for r rows; a slot with one row equal. Returns the
    largest error."""
    n = len(got)
    slots = slots[(slots >= 0) & (slots < n)]
    reps = np.bincount(slots, minlength=n)
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if (err > tol).any():
        raise AssertionError(f"{what}: {int((err > tol).sum())} slots past "
                             f"r spacings")
    return float(err.max())


def bench_cases(torch, K, ck, dev, rng) -> dict:
    """The bench's kernels against their plain versions, each run on a CPU
    copy of the same state, at the bench's widths: ``acquire_scan_packed24``
    (32 x 8192 on 10M slots: two launches), ``acquire_scan_compact_fused``
    (16 x 8192, a shape of ``acquire_scan``), ``acquire_batch`` at B = 8192
    with both ``handle_duplicates`` and at B = 8 and 64 with Zipf repeats,
    the last beside the flush on the same rows with prefix 0. Grants,
    remaining and integer state bit-equal; tokens bit-equal with the
    duplicate serialization (whole counts below 2^24 of demand), within r
    spacings without it."""
    res = {}
    n, now, cap, rate = BENCH_N_SLOTS, 5_000_000, 100.0, 50.0 / 1024
    arrays = (rng.uniform(0, cap, n).astype(np.float32),
              rng.integers(now - 3000, now, n).astype(np.int32),
              rng.random(n) < 0.7)

    def tables():
        return (K.BucketState(*(torch.tensor(a) for a in arrays)),
                K.BucketState(*(torch.tensor(a, device=dev) for a in arrays)))

    def same_state(what, card, plain):
        for field in plain._fields:
            _check_equal(f"{what} {field}", getattr(card, field),
                         getattr(plain, field))

    k, b = BENCH_SCAN_K, BENCH_BATCH
    nows = torch.tensor([now + 7 * (i // 4) for i in range(k)],
                        dtype=torch.int32)
    nows_d = nows.to(dev)

    # -- acquire_scan_packed24 at 32 x 8192 (the bench's uniform slots) and
    # Zipf(1.2) slots; 2% SLOT24_PAD, 1% ids >= N ---------------------------
    for label in ("uniform (the bench)", "Zipf(1.2)"):
        if label.startswith("uniform"):
            slots = rng.integers(0, n, (k, b))
        else:
            slots = np.minimum(rng.zipf(1.2, (k, b)) - 1, n - 1)
        slots[rng.random((k, b)) < 0.02] = K.SLOT24_PAD
        slots[rng.random((k, b)) < 0.01] = n + 3
        op = torch.from_numpy(K.pack_slots24(slots))
        op_d = op.to(dev)
        ps, ks = tables()
        before = ck.launches["acquire_scan24"]
        got = ck.acquire_scan_packed24(ks, op_d, nows_d, cap, rate)
        if ck.launches["acquire_scan24"] != before + 2:
            raise AssertionError("acquire_scan_packed24 at 32 x 8192: not "
                                 "two launches")
        want = ck.acquire_scan_packed24(ps, op, nows, cap, rate)
        torch.cuda.synchronize()
        _check_equal(f"acquire_scan24 {label} out", got, want)
        same_state(f"acquire_scan24 {label}", ks, ps)
        granted = int(want[:, 0].sum())
        if not 0 < granted < k * b:
            raise AssertionError(f"acquire_scan24 {label}: {granted} granted")
        live = slots[slots < n]
        d = len(np.unique(live))
        call = functools.partial(ck.acquire_scan_packed24, ks, op_d, nows_d,
                                 cap, rate)
        nbytes, ops = 3 * k * b + 4 * k + 8 * k * b + 18 * d, 15 * k * b
        row = _scan_row(call, nbytes, ops, 0.0)
        if label.startswith("uniform"):
            pc = K.BucketState(*(torch.tensor(a, device=dev)
                                 for a in arrays))
            row["plain_ms"] = _median_ms(functools.partial(
                K.acquire_scan_packed24, pc, op_d, nows_d, cap, rate),
                reps=3, warmup=1)
            res["acquire_scan24"] = dict(row, library_ms=None, bytes=nbytes,
                                         ops=ops)
            del pc
        else:
            res["acquire_scan24"]["shapes"] = {label: row}
        print(f"acquire_scan_packed24 K={k} B={b} on {n} slots, {label} "
              f"({d} distinct slots, {granted} granted): two launches, equal "
              f"to plain; {row['ms']:.4f} ms (device time {row['device_ms']} "
              f"ms, bound {row['bound_ms']:.5f})")
        del ps, ks
    torch.cuda.empty_cache()

    # -- acquire_scan_compact_fused at 16 x 8192 (a shape of acquire_scan) --
    kc = BENCH_COMPACT_K
    for label, counts in (("uniform, count 1 (the bench)", None),
                          ("Zipf(1.2), counts 0-3", "zipf")):
        if counts is None:
            slots = rng.integers(0, n, (kc, b)).astype(np.int32)
            cnt = np.ones((kc, b), np.uint8)
        else:
            slots = np.minimum(rng.zipf(1.2, (kc, b)) - 1, n - 1).astype(
                np.int32)
            cnt = rng.integers(0, 4, (kc, b)).astype(np.uint8)
        slots[rng.random((kc, b)) < 0.02] = -1
        op = torch.from_numpy(K.pack_compact5(slots, cnt))
        op_d = op.to(dev)
        ps, ks = tables()
        before = ck.launches["acquire_scan"]
        got = ck.acquire_scan_compact_fused(ks, op_d, nows_d[:kc], cap, rate)
        if ck.launches["acquire_scan"] != before + 1:
            raise AssertionError("acquire_scan_compact_fused at 16 x 8192: "
                                 "not one launch")
        want = ck.acquire_scan_compact_fused(ps, op, nows[:kc], cap, rate)
        torch.cuda.synchronize()
        _check_equal(f"compact_fused {label} out", got, want)
        same_state(f"compact_fused {label}", ks, ps)
        d = len(np.unique(slots[slots >= 0]))
        row = _scan_row(functools.partial(
            ck.acquire_scan_compact_fused, ks, op_d, nows_d[:kc], cap, rate),
            5 * kc * b + 4 * kc + 8 * kc * b + 18 * d, 15 * kc * b, 0.0)
        res.setdefault("compact_shapes", {})[
            f"compact_fused {kc} x {b}, {label}"] = row
        print(f"acquire_scan_compact_fused K={kc} B={b}, {label}: one "
              f"launch, equal to plain; {row['ms']:.4f} ms (device time "
              f"{row['device_ms']} ms)")
        del ps, ks
    torch.cuda.empty_cache()

    # -- acquire_batch: B = 8192 (the bench's slots), both flags; B = 8 and
    # 64 with Zipf repeats, both flags, beside the flush ---------------------
    shapes = {}
    for bb, label in ((b, "uniform"), *((x, "Zipf(1.2)")
                                        for x in BENCH_SMALL_B)):
        if label == "uniform":
            slots = rng.integers(0, n, bb).astype(np.int32)
            cnt = np.ones(bb, np.int32)
        else:
            slots = (np.minimum(rng.zipf(1.2, bb) - 1, 50)
                     * 1009).astype(np.int32)
            cnt = rng.integers(0, 4, bb).astype(np.int32)
        valid = rng.random(bb) < 0.97
        args = [torch.from_numpy(a) for a in (slots, cnt, valid)]
        args_d = [a.to(dev) for a in args]
        for dup in (False, True):
            ps, ks = tables()
            before = ck.launches["acquire_batch"]
            got = ck.acquire_batch(ks, *args_d, now, cap, rate,
                                   handle_duplicates=dup)
            if ck.launches["acquire_batch"] != before + 1:
                raise AssertionError("acquire_batch: not one launch")
            want = ck.acquire_batch(ps, *args, now, cap, rate,
                                    handle_duplicates=dup)
            torch.cuda.synchronize()
            what = f"acquire_batch B={bb} {label} dup={dup}"
            _check_equal(f"{what} out", got, want)
            for field in ("last_ts", "exists"):
                _check_equal(f"{what} {field}", getattr(ks, field),
                             getattr(ps, field))
            if dup:
                _check_equal(f"{what} tokens", ks.tokens, ps.tokens)
                err = 0.0
            else:
                err = _check_within_adds(what, slots[valid],
                                         ks.tokens.cpu().numpy(),
                                         ps.tokens.numpy())
            flush_ms = None
            if not dup and bb <= ck.FLUSH_MAX_BATCH:
                # The flush on the same rows with prefix 0 decides alike:
                # its time is what a row-sized route would cost.
                packed = np.zeros((4, bb), np.int32)
                packed[0] = np.where(valid, slots, -1)
                packed[1], packed[2] = cnt, now
                packed_d = torch.from_numpy(packed).to(dev)
                fs = K.BucketState(*(torch.tensor(a, device=dev)
                                     for a in arrays))
                fout = ck.acquire_packed(fs, packed_d, cap, rate)
                torch.cuda.synchronize()
                _check_equal(f"{what} flush route out", fout, got)
                _check_equal(f"{what} flush route tokens", fs.tokens,
                             ks.tokens)
                flush_ms = _device_ms(functools.partial(
                    ck.acquire_packed, fs, packed_d, cap, rate),
                    FLUSH_KERNELS)
                del fs
            d = len(np.unique(slots[valid]))
            call = functools.partial(ck.acquire_batch, ks, *args_d, now, cap,
                                     rate, handle_duplicates=dup)
            row = _scan_row(call, 13 * bb + 8 * bb + 18 * d, 15 * bb, err)
            shape = f"B={bb}, {label}, handle_duplicates={dup}"
            if flush_ms is not None:
                row["flush_route_device_ms"] = flush_ms
            if bb == b and not dup:
                pc = K.BucketState(*(torch.tensor(a, device=dev)
                                     for a in arrays))
                plain_ms = _median_ms(functools.partial(
                    K.acquire_batch, pc, *args_d, now, cap, rate,
                    handle_duplicates=False), reps=5, warmup=1)
                del pc
                res["acquire_batch"] = dict(
                    row, plain_ms=plain_ms, library_ms=None,
                    bytes=13 * bb + 8 * bb + 18 * d, ops=15 * bb)
            else:
                shapes[shape] = row
            print(f"{what}: one launch, equal to plain (tokens max err "
                  f"{err:.3g}); {row['ms']:.4f} ms (device time "
                  f"{row['device_ms']} ms; flush route "
                  f"{row.get('flush_route_device_ms', 'n/a')} ms)")
            del ps, ks
    res["acquire_batch"]["shapes"] = shapes
    torch.cuda.empty_cache()
    return res


async def bench_path(torch, ck, pkg, card: str) -> dict:
    """The port's bench (``redis_tpu_torch/bench.py``), its headline,
    compact and single-batch sections at their full widths on the 10M-slot
    table, ``BENCH_ITERS`` dispatches each in one window; returns the kernel
    launches they made."""
    from distributedratelimiting.redis_tpu_torch import bench

    dev = torch.device("cuda")
    clock = pkg.MonotonicClock()
    ck.reset_launches()
    rate, state, detail = bench.bench_kernel_throughput(
        dev, clock, iters=BENCH_ITERS, windows=1)
    compact = bench.bench_compact_throughput(state, dev, clock,
                                             iters=BENCH_ITERS, windows=1)
    single = bench.bench_single_batch(state, dev, clock, iters=BENCH_ITERS,
                                      windows=1)
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    # Warm-up, the timed window and the headline's profiled dispatches.
    want = {"acquire_scan24": 2 * (1 + BENCH_ITERS + detail["profiled"]),
            "acquire_scan": 1 + BENCH_ITERS,
            "acquire_batch": 1 + BENCH_ITERS}
    got = {name: counts[name] for name in want}
    if got != want or sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"bench path launches {counts}, want {want}")
    tokens = state.tokens
    live = int(state.exists.sum())
    if not (bool(torch.isfinite(tokens).all())
            and float(tokens.max()) <= bench.CAPACITY and live > 0):
        raise AssertionError("bench path: table not sane after the sections")
    print(f"bench path ({card}), {BENCH_ITERS} dispatches a section: "
          f"headline {rate:.0f} decisions/s, compact {compact:.0f}, single "
          f"batch {single:.0f}; headline {detail}; {live} live slots")
    del state
    torch.cuda.empty_cache()
    return counts


# -- phase 13: the native front-end and tier-0 (--paths native) -------------

NATIVE_SEED = 1616
NATIVE_REQS = 100_000          # ACQUIRE frames a depth (native_loadgen)
NATIVE_KEYS = 1_000_000        # the loadgen's keyspace
NATIVE_CONNS = 4
NATIVE_DEPTHS = (64, 256)
NATIVE_ASYNCIO_DEPTH = 64      # the asyncio lane beside it, same keys
NATIVE_ASYNCIO_REQS = 25_000   # its requests (~7,600-13,200 a second)
NATIVE_MIXED_FRAMES = 800      # the seeded mixed sequence
NATIVE_T0_CAP = 20_000.0       # tier-0's exhausted hot keys (fill ~ 0)
NATIVE_T0_REQS = 40_000        # a hot key's requests (one per connection)
NATIVE_T0_COLD = 40_000        # the cold tail's requests (and keyspace)
NATIVE_T0_PEEK = (1e6, 30_000)  # an unexhausted key: capacity, requests
NATIVE_SHARD_FRAMES = 60       # bulk frames a connection (4,096 rows each)
#: Keys a bulk call: the C lane parks a connection's chained chunks behind
#: the one in flight up to 64 MB (frontend.cc kMaxConnOut), past which it
#: answers an error and drops the connection; a 10M-key call is ~170 MB.
NATIVE_BULK_CALL = 1_000_000
NATIVE_SHARDS = (1, 4)
#: The native servers' tier-0: the bench's cadence and ceiling.
NATIVE_T0_SYNC_S = 0.01


async def _native_client_run(host: str, port: int, mode: str,
                             args: list) -> dict:
    """The native path's client process (``chip_smoke.py --native-client
    HOST PORT MODE ...``): C load generators (they block, so each runs in
    a thread) and the server's own stats between them."""
    import threading

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        native_bulk_loadgen,
        native_loadgen,
    )
    from distributedratelimiting.redis_tpu_torch.runtime.remote import (
        RemoteBucketStore,
    )

    store = RemoteBucketStore(address=(host, port), coalesce_requests=False)
    out: dict = {}
    try:
        if mode == "scalar":
            reqs, keyspace, *depths = map(int, args)
            for depth in depths:
                await store.stats(reset=True)
                replies, granted, el = await asyncio.to_thread(
                    native_loadgen, host, port, conns=NATIVE_CONNS,
                    depth=depth, reqs_per_conn=reqs // NATIVE_CONNS,
                    keyspace=keyspace)
                st = await store.stats()
                out[f"d{depth}"] = {
                    "replies": replies, "granted": granted, "s": el,
                    "rate": replies / el, "p50_ms": st["serving_p50_ms"],
                    "p99_ms": st["serving_p99_ms"],
                    "samples": st["serving_samples"]}
        elif mode == "tier0":
            cap, reqs, cold, peek_cap, peek_reqs = map(float, args)
            # The hot set: one key a connection (keyspace 1), exhausted.
            replies, granted, el = await asyncio.to_thread(
                native_loadgen, host, port, conns=NATIVE_CONNS, depth=64,
                reqs_per_conn=int(reqs), keyspace=1, capacity=cap,
                fill_rate=1e-9)
            out["hot"] = {"replies": replies, "granted": granted, "s": el,
                          "rate": replies / el}
            # The cold tail: a keyspace of its own config, never exhausted.
            replies, granted, el = await asyncio.to_thread(
                native_loadgen, host, port, conns=NATIVE_CONNS, depth=64,
                reqs_per_conn=int(cold) // NATIVE_CONNS,
                keyspace=int(cold), capacity=1e7, fill_rate=1e7)
            out["cold"] = {"replies": replies, "granted": granted,
                           "s": el, "rate": replies / el}
            # One key that stays unexhausted: its peek shows the debit.
            replies, granted, el = await asyncio.to_thread(
                native_loadgen, host, port, conns=1, depth=64,
                reqs_per_conn=int(peek_reqs), keyspace=1,
                capacity=peek_cap, fill_rate=1e-9)
            out["peek"] = {"replies": replies, "granted": granted}
        else:  # shards: the bulk loadgen from several threads
            frames, n_threads = map(int, args)
            rows_out: list = []

            def one() -> None:
                rows_out.append(native_bulk_loadgen(
                    host, port, conns=4, depth=8, frames_per_conn=frames,
                    rows_per_frame=4096, keyspace=64))

            # Warm: connects and installs the 64 hot keys' replicas.
            native_bulk_loadgen(host, port, conns=4, depth=2,
                                frames_per_conn=10, rows_per_frame=1024,
                                keyspace=64)
            await store.stats(reset=True)
            th = [threading.Thread(target=one) for _ in range(n_threads)]
            t0 = time.perf_counter()
            for t in th:
                t.start()
            for t in th:
                t.join()
            wall = time.perf_counter() - t0
            st = await store.stats()
            rows = sum(r for _f, r, _g, _el in rows_out)
            out = {"rows": rows, "granted": sum(g for *_x, g, _el
                                                in rows_out),
                   "rows_per_s": rows / wall,
                   "p50_ms": st["serving_p50_ms"],
                   "p99_ms": st["serving_p99_ms"],
                   "native_bulk": st.get("native_bulk"),
                   "tier0_hit_rate": st.get("tier0", {}).get("hit_rate"),
                   "per_shard_rows": [r["native_bulk"]["rows"]
                                      for r in st.get("shards", [])]}
    finally:
        await store.aclose()
    return out


async def _native_client(host: str, port: int, mode: str, *args) -> dict:
    """Run :func:`_native_client_run` in a process of its own (a client
    host) and return its JSON line."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), "--native-client", host,
        str(port), mode, *map(str, args), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 600)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"native client ({mode}) exited "
                             f"{proc.returncode}: {err.decode()[-3000:]}")
    return json.loads(out.decode().strip().splitlines()[-1])


def _native_frames(rng, n: int) -> list:
    """The seeded mixed sequence: ``(frames, advance_ticks)`` steps, each
    one frame or a pipelined pair of chained ACQUIRE_MANY chunks, over a
    few hot keys so limits bind. Covers ACQUIRE (probes too), WINDOW,
    FWINDOW, SEMA acquire then release on one key, PEEK, HELLO and the
    chained chunks; the malformed frame comes last, on its own."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    steps = []
    seq = 1
    keys = [f"mx{i}" for i in range(12)]
    for _ in range(n):
        kind = rng.integers(0, 8)
        key = keys[int(rng.integers(0, len(keys)))]
        tick = int(rng.integers(0, 3)) * 40
        if kind <= 1:
            fr = [wire.encode_request(seq, wire.OP_ACQUIRE, key,
                                      int(rng.integers(0, 3)), 8.0, 4.0)]
        elif kind == 2:
            fr = [wire.encode_request(seq, wire.OP_WINDOW, key, 1, 6.0,
                                      1.0)]
        elif kind == 3:
            fr = [wire.encode_request(seq, wire.OP_FWINDOW, key, 1, 5.0,
                                      0.5)]
        elif kind == 4:
            # SEMA acquire then release on one key, pipelined.
            fr = [wire.encode_request(seq, wire.OP_SEMA, "s" + key, 1, 3.0),
                  wire.encode_request(seq + 1, wire.OP_SEMA, "s" + key, -1,
                                      0.0)]
        elif kind == 5:
            fr = [wire.encode_request(seq, wire.OP_PEEK, key, 0, 8.0, 4.0)]
        elif kind == 6:
            fr = [wire.encode_request(seq, wire.OP_HELLO, "")]
        else:
            # Chained ACQUIRE_MANY chunks with repeats across the boundary.
            ks = [keys[int(i)] for i in rng.integers(0, len(keys), 24)]
            kb = [k.encode() for k in ks]
            fr = [wire.encode_bulk_request(seq, kb[:12], np.ones(12),
                                           8.0, 4.0),
                  wire.encode_bulk_request(seq + 1, kb[12:], np.ones(12),
                                           8.0, 4.0, chained=True)]
        seq += len(fr)
        steps.append((fr, tick))
    # A malformed bulk frame (it declares more keys than it carries): the
    # passthrough lane answers it with the asyncio handler's error.
    bad = wire.encode_bulk_request(seq, [b"mx0", b"mx1"], np.ones(2), 8.0,
                                   4.0)
    bad = bad[:-4]
    bad = len(bad[4:]).to_bytes(4, "little") + bad[4:]
    steps.append(([bad], 0))
    return steps


async def _native_replay(addr, steps, clock) -> list:
    """Send the steps on one connection, each step's frames pipelined and
    its replies read before the next; the clock advances between steps.
    Returns the replies, each step's sorted by seq."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    reader, writer = await asyncio.open_connection(*addr)
    out = []
    try:
        for frames, tick in steps:
            clock.advance_ticks(tick)
            for fr in frames:
                writer.write(fr)
            await writer.drain()
            got = []
            for _ in frames:
                body = await asyncio.wait_for(wire.read_frame(reader), 30)
                if body is None:
                    break
                got.append(body)
            out.extend(sorted(got, key=lambda b: b[1:5]))
    finally:
        writer.close()
    return out


async def native_path(torch, ck, pkg, card: str) -> dict:
    """The native serving front-end and tier-0 on the card
    (``native/frontend.cc`` through ``runtime/native_frontend.py``): a
    ``BucketStoreServer(native_frontend=True)`` over a card
    ``DeviceBucketStore`` of 2^24 slots, the server path's size. Returns
    the kernel launches the path made."""
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
        overadmit_epsilon,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import wire
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        Tier0Config,
        uring_probe,
    )

    ck.reset_launches()
    # An unadvanced ManualClock: the bulk phase compares remaining with an
    # equal store's, so no refill may land between their calls.
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  max_batch=BATCH,
                                  clock=pkg.ManualClock(1_000_000))
    srv = pkg.BucketStoreServer(store, native_frontend=True)
    host, port = await srv.start()
    asy = pkg.BucketStoreServer(store)
    _, aport = await asy.start()

    # 1. Scalar lane: native_loadgen from a client process of its own.
    launches0 = dict(ck.launches)
    nat = await _native_client(host, port, "scalar", NATIVE_REQS,
                               NATIVE_KEYS, *NATIVE_DEPTHS)
    for d, r in nat.items():
        if r["replies"] != NATIVE_REQS or r["granted"] != NATIVE_REQS:
            raise AssertionError(f"native scalar {d}: {r}")
        print(f"native scalar ACQUIRE {d} ({NATIVE_CONNS} connections, "
              f"{NATIVE_KEYS} keys, native_loadgen): {r['replies']} "
              f"requests in {r['s']:.3f} s = {r['rate']:.0f} requests/s "
              f"({card}); server C histogram p50 {r['p50_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms ({r['samples']} samples)")
    flushes = {k: ck.launches[k] - launches0.get(k, 0)
               for k in ("acquire_packed", "acquire_grouped")}
    old = await _native_client(host, aport, "scalar", NATIVE_ASYNCIO_REQS,
                               NATIVE_KEYS, NATIVE_ASYNCIO_DEPTH)
    for d, r in old.items():
        if (r["replies"] != NATIVE_ASYNCIO_REQS
                or r["granted"] != NATIVE_ASYNCIO_REQS):
            raise AssertionError(f"asyncio scalar {d}: {r}")
        print(f"asyncio scalar ACQUIRE {d} (the same keys and client): "
              f"{r['rate']:.0f} requests/s ({card}); server p50 "
              f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; native/"
              f"asyncio {nat[d]['rate'] / r['rate']:.1f}x")
    print(f"native scalar flushes: {flushes}")

    # 2. Exactness: cap-5 x 32 -> 5 through the native batch lane.
    solo = pkg.RemoteBucketStore(address=(host, port),
                                 coalesce_requests=False)
    for what, call in (
            ("bucket", lambda: solo.acquire("cap5", 1, 5.0, 1e-9)),
            ("window", lambda: solo.window_acquire("cap5", 1, 5.0, 3600.0)),
            ("fixed window",
             lambda: solo.fixed_window_acquire("cap5", 1, 5.0, 3600.0)),
            ("semaphore", lambda: solo.concurrency_acquire("cap5", 1, 5))):
        res = await asyncio.gather(*(call() for _ in range(32)))
        got = sum(bool(r.granted) for r in res)
        if got != 5:
            raise AssertionError(f"native cap-5 x 32 ({what}): {got}")
    print("native cap-5 x 32 -> 5: bucket, window, fixed window, semaphore")

    # 3. The seeded mixed sequence, byte for byte against the asyncio lane
    # over an equal card store on one ManualClock schedule, tier-0 off.
    pairs = []
    for native in (True, False):
        clock = pkg.ManualClock(1_000_000)
        st = pkg.DeviceBucketStore(device="cuda", n_slots=1 << 16,
                                   max_batch=BATCH, clock=clock)
        s = pkg.BucketStoreServer(st, native_frontend=native)
        pairs.append((st, s, await s.start(), clock))
    steps = _native_frames(np.random.default_rng(NATIVE_SEED),
                           NATIVE_MIXED_FRAMES)
    replies = [await _native_replay(addr, steps, clock)
               for _st, _s, addr, clock in pairs]
    if replies[0] != replies[1]:
        bad = next(i for i, (a, b) in enumerate(zip(*replies)) if a != b) \
            if len(replies[0]) == len(replies[1]) else "count"
        raise AssertionError(f"native mixed sequence: reply {bad} differs "
                             "from the asyncio lane's")
    if wire.decode_response(replies[0][-1])[1] != wire.RESP_ERROR:
        raise AssertionError("native mixed sequence: malformed frame "
                             "answered without an error")
    _snapshots_equal("native mixed sequence", pairs[0][0].snapshot(),
                     pairs[1][0].snapshot())
    print(f"native mixed sequence: {len(replies[0])} replies to "
          f"{sum(len(f) for f, _ in steps)} frames equal byte for byte to "
          "the asyncio lane's, and the stores' states equal")
    for st, s, _addr, _clock in pairs:
        await s.aclose()
        await st.aclose()

    # 4. Tier-0: a hot set and a cold tail; the over-admission within its
    # epsilon against the device-only oracle, and the debit reconciled.
    cfg = Tier0Config(sync_interval_s=NATIVE_T0_SYNC_S,
                      max_budget=float(1 << 24))
    t0srv = pkg.BucketStoreServer(store, native_frontend=True,
                                  native_tier0=cfg)
    _, t0port = await t0srv.start()
    d0 = ck.launches["debit_packed"]
    rep = await _native_client(host, t0port, "tier0", NATIVE_T0_CAP,
                               NATIVE_T0_REQS, NATIVE_T0_COLD,
                               *NATIVE_T0_PEEK)
    # Quiescence: every local grant drained and acked.
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        await asyncio.sleep(NATIVE_T0_SYNC_S * 5)
        t0 = t0srv._native.tier0_stats()
        if t0["carry_keys"] == 0 and t0["last_sync_age_s"] >= 0:
            break
    await asyncio.sleep(NATIVE_T0_SYNC_S * 5)
    t0 = t0srv._native.tier0_stats()
    fill = 1e-9
    budget = headroom_budget(NATIVE_T0_CAP, fraction=cfg.budget_fraction,
                             min_budget=cfg.min_budget,
                             max_budget=cfg.max_budget)
    eps = overadmit_epsilon(budget, fill, cfg.sync_interval_s)
    hot = rep["hot"]["granted"]
    oracle = NATIVE_CONNS * NATIVE_T0_CAP
    if not (t0["overadmit_max"] <= eps and hot <= oracle + NATIVE_CONNS * eps
            and abs(hot - (oracle + t0["overadmit_total"])) <= 1.0):
        raise AssertionError(f"tier-0: {hot} granted on {NATIVE_CONNS} hot "
                             f"keys, oracle {oracle:.0f}, epsilon {eps}, "
                             f"{t0}")
    peeks = [store.peek_blocking(f"lg{i}-0", NATIVE_T0_CAP, fill)
             for i in range(NATIVE_CONNS)]
    pcap, preqs = NATIVE_T0_PEEK
    left = store.peek_blocking("lg0-0", pcap, fill)
    if max(peeks) > 1.0 or abs(left - (pcap - preqs)) > 1.0 \
            or rep["peek"]["granted"] != preqs:
        raise AssertionError(f"tier-0 reconcile: hot peeks {peeks}, "
                             f"unexhausted key {left} (want "
                             f"{pcap - preqs})")
    debits = ck.launches["debit_packed"] - d0
    if debits <= 0 or t0["hits"] <= 0:
        raise AssertionError(f"tier-0: {debits} debits, {t0}")
    print(f"native tier-0 ({card}): hot {NATIVE_CONNS} keys x "
          f"{NATIVE_T0_REQS} at {rep['hot']['rate']:.0f} requests/s, cold "
          f"tail {NATIVE_T0_COLD} at {rep['cold']['rate']:.0f}; hit rate "
          f"{t0['hit_rate']:.4f} ({t0['hits']} hits, {t0['local_denies']} "
          f"local denies, {t0['misses']} misses); {hot} granted on the hot "
          f"keys against the device-only oracle's {oracle:.0f}: "
          f"overadmit_total {t0['overadmit_total']}, overadmit_max "
          f"{t0['overadmit_max']} <= epsilon {eps:.6g}; {t0['syncs']} "
          f"syncs, {debits} debit_packed launches; peek after quiescence "
          f"{left} = {pcap:.0f} - {preqs}")
    await t0srv.aclose()

    # 5. The bulk lane: the 10M keys as ACQUIRE_MANY frames in calls of
    # NATIVE_BULK_CALL keys, the residue (every row: tier-0 is off) decided
    # by the store's scan; the asyncio lane over an equal store on the same
    # frames.
    opts = pkg.TokenBucketOptions(token_limit=100, tokens_per_period=10,
                                  replenishment_period_s=1.0,
                                  instance_name="native")
    store2 = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                   max_batch=BATCH,
                                   clock=pkg.ManualClock(1_000_000))
    asy2 = pkg.BucketStoreServer(store2)
    _, a2port = await asy2.start()
    grants = []
    for lane, p in (("native", port), ("asyncio", a2port)):
        cli = pkg.RemoteBucketStore(address=(host, p),
                                    request_timeout_s=600.0)
        lim = pkg.PartitionedRateLimiter(opts, cli)
        scans0 = ck.launches["acquire_scan"]
        t = time.perf_counter()
        granted = []
        for lo in range(0, N_KEYS, NATIVE_BULK_CALL):
            res = await lim.acquire_many(
                range(lo, min(lo + NATIVE_BULK_CALL, N_KEYS)), permits=1,
                with_remaining=False)
            granted.append(np.asarray(res.granted))
        dt = time.perf_counter() - t
        res2 = await lim.acquire_many(range(0, N_KEYS, 10), permits=1)
        grants.append((np.concatenate(granted), np.asarray(res2.granted),
                       np.asarray(res2.remaining)))
        print(f"{lane} bulk over the wire: {N_KEYS} keys in {dt:.3f} s = "
              f"{N_KEYS / dt:.0f} rows/s ({card}); "
              f"{ck.launches['acquire_scan'] - scans0} acquire_scan "
              f"launches; then {len(res2)} with remaining")
        await cli.aclose()
    nb = srv._native.bulk_stats()
    if not (all(np.array_equal(a, b) for a, b in zip(*grants))
            and grants[0][0].all() and np.all(grants[0][2] == 98.0)
            and nb["rows_residue"] >= N_KEYS):
        raise AssertionError(f"native bulk grants differ from the asyncio "
                             f"lane's, or not all residue: {nb}")
    print(f"native bulk: grants and remaining equal the asyncio lane's; "
          f"{nb}")
    await asy2.aclose()
    await store2.aclose()
    del store2
    torch.cuda.empty_cache()

    # 6. Shards 1 and 4 (the bulk loadgen, hot 64 keys, tier-0 on), and
    # the io_uring probe with each shard's transport.
    ok, reason = uring_probe()
    print(f"io_uring probe: available {ok}: {reason}")
    for shards in NATIVE_SHARDS:
        s = pkg.BucketStoreServer(store, native_frontend=True,
                                  native_tier0=cfg, native_shards=shards)
        _, sport = await s.start()
        r = await _native_client(host, sport, "shards",
                                 NATIVE_SHARD_FRAMES, max(6, 4 * shards))
        nb = r["native_bulk"]
        frac = nb["rows_local"] / max(nb["rows"], 1)
        if r["granted"] != r["rows"]:
            raise AssertionError(f"shards {shards}: {r}")
        print(f"native shards {shards} ({card}): {r['rows']} bulk rows at "
              f"{r['rows_per_s']:.0f} rows/s, local_frac {frac:.4f}, "
              f"tier-0 hit rate {r['tier0_hit_rate']}, server p99 "
              f"{r['p99_ms']:.3f} ms; rows by shard {r['per_shard_rows']}")
        await s.aclose()
    u = pkg.BucketStoreServer(store, native_frontend=True, native_shards=4,
                              native_uring="on")
    await u.start()
    tr = u._native.transport_stats()
    print(f"io_uring requested on 4 shards: {tr['uring_shards']} on the "
          f"ring; per-shard epoll reasons {u._native.uring_reasons()}")
    await u.aclose()
    await asy.aclose()
    await srv.aclose()
    counts = dict(ck.launches)
    await store.aclose()
    return counts


#: Wrappers whose launches :func:`_record_sizes` counts by operand width,
#: by the kernel's name: B for a flush, a sync or a debit; K x B rows for a
#: bulk-lane scan.
# -- phase 14: the device-resident fingerprint directory (--paths fp) -------

FP_SEED = 1717
FP_SLOTS = 2**24
FP_L = 16          # the store's probe window
FP_R = 4           # the plain version's claim rounds (JAX's R)
#: Keys placed in the kernel cases' tables before each case.
FP_PRESENT = 1_000_000
#: The store part: BASELINE's 10M-key tables, in calls of 1M keys.
FP_KEYS = 10_000_000
FP_CALL = 1_000_000
FP_CAP = 5.0
FP_RATE = 1.0
FP_PEEKS = 2_500   # 10,000 until the drain path joined the script
FP_DEBIT_KEYS = 100_000
#: The growth case: a 2^20-slot store fed 2M keys in calls of 2^17.
FP_GROW_SLOTS = 2**20
FP_GROW_KEYS = 2_000_000
FP_GROW_CALL = 1 << 17
#: The migrate case: a 2^22-slot table's entries into 2^23 slots.
FP_MIGRATE_FROM = 2**22
FP_MIGRATE_ENTRIES = 1_000_000
#: The window tier's limit and window (one second).
FP_WLIMIT = 6.0
FP_WINDOW_S = 1.0
#: Each fp kernel's results for the kernels line, filled by the fp path.
FP_RESULTS: dict = {}
#: The CUDA kernels each fp wrapper launches (their device time).
FP_KERNEL_NAMES = {
    # The flush form at K = 1 (one launch: a warp kernel up to 32 rows,
    # blocks up to 4,096), else the resolve and the scan's fingerprint form.
    "fp_decide": ("fp_flush_warp_kernel", "fp_flush_block_kernel",
                  "resolve_kernel", "scan_kernel"),
    "fp_window_decide": ("fp_flush_warp_kernel", "fp_flush_block_kernel",
                         "resolve_kernel", "scan_kernel"),
    "fp_debit": ("resolve_kernel", "tally_", "debit_fix_kernel"),
    "fp_peek": ("peek_kernel",),
    "fp_sweep": ("sweep_bucket_kernel",),
    "fp_sweep_windows": ("sweep_window_kernel",),
    "fp_migrate": ("migrate_kernel",),
    "fp_migrate_window": ("migrate_kernel",),
}


def _fp_keys(rng, m: int) -> np.ndarray:
    return rng.integers(1, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)


def _fp_base(torch, K, F, rng, n: int, present: int, kind: str,
             n_shards: int = 1):
    """A CPU table of ``n`` slots (in ``n_shards`` shard regions) with
    ``present`` keys placed (the plain resolve) and random state on the
    claimed cells only (an empty cell holds none: claims and sweeps keep it
    so). Returns (keys, (fp, state))."""
    keys = _fp_keys(rng, present)
    fp = F.init_fp_table(n)
    F.fp_resolve(fp, torch.from_numpy(keys.view(np.int32)),
                 torch.ones(present, dtype=torch.bool), probe_window=FP_L,
                 rounds=FP_R, n_shards=n_shards)
    live = (fp != 0).any(1).numpy()
    now = 1 << 20
    if kind == "bucket":
        cols = [rng.uniform(0, FP_CAP, n).astype(np.float32),
                rng.integers(now - 4096, now, n).astype(np.int32),
                np.ones(n, bool)]
        cls = K.BucketState
    else:
        cols = [rng.integers(0, 4, n).astype(np.float32),
                rng.integers(0, 4, n).astype(np.float32),
                rng.integers(now // 1024 - 3, now // 1024 + 1,
                             n).astype(np.int32),
                np.ones(n, bool)]
        cls = K.WindowState
    for c in cols:
        c[~live] = 0
    return keys, (fp, cls(*(torch.from_numpy(c) for c in cols)))


def _fp_copy(table, dev=None):
    fp, st = table
    if dev is None:
        return fp.clone(), type(st)(*(t.clone() for t in st))
    return fp.to(dev), type(st)(*(t.to(dev) for t in st))


def _fp_rows(rng, keys, m: int, dist: str) -> np.ndarray:
    """``m`` request keys: half of them present, half new; distinct, or
    Zipf(1.2) over that pool."""
    half = min(m // 2, len(keys))
    pool = np.concatenate([keys[rng.permutation(len(keys))[:half]],
                           _fp_keys(rng, m - half)])
    if dist == "distinct":
        return pool[rng.permutation(len(pool))]
    return pool[np.minimum(rng.zipf(1.2, m) - 1, len(pool) - 1)]


def _fp_same_by_key(F, what, cpu, dev, keys, n_shards: int = 1) -> tuple:
    """The card's table against the plain version's BY KEY: the card's
    invariants hold (no key in two cells, every cell in its key's window,
    in its shard region), each key is present in both or in neither, its
    state fields equal (floats within ATOL). Returns (claimed cells, max
    abs error)."""
    fp_c = cpu[0].numpy().view(np.uint32)
    fp_d = dev[0].cpu().numpy().view(np.uint32)
    n_d = F.check_table_np(fp_d, FP_L, n_shards)
    n_c = int((fp_c != 0).any(1).sum())
    if n_d != n_c:
        raise AssertionError(f"{what}: {n_d} cells claimed on the card, "
                             f"{n_c} in the plain version")
    sc = F.find_np(fp_c, keys, FP_L, n_shards)
    sd = F.find_np(fp_d, keys, FP_L, n_shards)
    if not np.array_equal(sc >= 0, sd >= 0):
        raise AssertionError(f"{what}: {int(((sc >= 0) != (sd >= 0)).sum())}"
                             " keys present on one side only")
    hit = sc >= 0
    err = 0.0
    for name, a, b in zip(cpu[1]._fields, cpu[1], dev[1]):
        a = a.numpy()[sc[hit]]
        b = b.cpu().numpy()[sd[hit]]
        if a.dtype == np.float32:
            e = float(np.abs(a.astype(np.float64) - b).max(initial=0.0))
            if not e <= ATOL:
                raise AssertionError(f"{what}: {name} by key, max abs error "
                                     f"{e}")
            err = max(err, e)
        elif not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs by key")
    return n_d, err


#: Timed fp calls whose profiler trace held no kernel at all (ROADMAP C1).
FP_C1: list = []


def _device_split(fn, names, reps=20, setup=None) -> dict:
    """Device ms per call of each named CUDA kernel (a kernel matches a
    name it contains), from one ``torch.profiler`` trace of ``reps`` calls
    (each after ``setup``): ``{name: ms or None}``, and under ``"trace"``
    the device ms per call of every kernel in the trace (0 when the trace
    recorded none: ROADMAP C1)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    events = [(e.key, getattr(e, "self_device_time_total", 0.0))
              for e in prof.key_averages()]
    out = {}
    for name in names:
        us = sum(t for key, t in events if name in key)
        out[name] = us / 1e3 / reps if us > 0 else None
    out["trace"] = sum(t for _, t in events) / 1e3 / reps
    return out


def _fp_time(torch, name: str, call, plain=None, setup=None) -> dict:
    """A launch's event ms (median), its kernels' device ms (profiler: the
    sum, and ``split`` per kernel of :data:`FP_KERNEL_NAMES`) and, where
    given, its plain version's ms; ``setup`` (untimed) runs before each
    call. A trace with device time in which no kernel of the wrapper
    shows raises (a stale name); a trace with none at all is ROADMAP C1:
    device_ms None, the case listed in :data:`FP_C1`."""
    split = _device_split(call, FP_KERNEL_NAMES[name], reps=10, setup=setup)
    trace = split.pop("trace")
    known = [v for v in split.values() if v is not None]
    if not known and trace > 0:
        raise AssertionError(f"{name}: the trace holds {trace:.5f} ms of "
                             f"device time a call, none of it in "
                             f"{FP_KERNEL_NAMES[name]}")
    if not known:
        FP_C1.append(name)
        print(f"{name}: device time not measured (the trace holds no "
              "kernel: ROADMAP C1)")
    out = {"ms": _median_ms(call, setup=setup, reps=10, warmup=2),
           "device_ms": sum(known) if known else None, "split": split}
    if plain is not None:
        out["plain_ms"] = _median_ms(plain, reps=2, warmup=0)
    return out


def _split_text(row: dict) -> str:
    """A timed row's device ms per kernel, for its printed line."""
    return ", ".join(f"{k} {v}" for k, v in row["split"].items())


def _fp_record(name: str, case: str, row: dict, err: float, nbytes: float,
               ops: float, first: bool = False) -> None:
    """One case of an fp kernel: its times and bound in ``shapes``; the
    kernel's line takes the store's main shape (``first``) and the largest
    error of any case."""
    bound_ms, bound_by = _bound_ms(nbytes, ops)
    r = FP_RESULTS.setdefault(name, {"max_abs_err": 0.0, "shapes": {},
                                     "library_ms": None})
    r["shapes"][case] = dict(row, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if first or "ms" not in r:
        r.update(ms=row["ms"], device_ms=row["device_ms"],
                 plain_ms=row.get("plain_ms"), bytes=nbytes, ops=ops)


def _fp_kernel_phase(torch, ck, card: str) -> None:
    """The fp kernel cases, timed. The whole script runs them right after
    the kernel phase, in a process that has run no path yet: there its
    ``torch.profiler`` sessions record the kernels' device time, which
    sessions late in a long run may not (ROADMAP C1)."""
    from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    fp_kernel_cases(torch, K, F, ck, torch.device("cuda"),
                    np.random.default_rng(FP_SEED))
    print(f"fp kernel cases ({card}): {time.perf_counter() - t0:.1f} s")


def _fp_fresh(torch, F, cls, n: int, like, dev=None):
    """An empty table of ``n`` cells, its state of ``like``'s family."""
    return (F.init_fp_table(n, dev or "cpu"),
            cls(*(torch.zeros(n, dtype=t.dtype, device=dev or "cpu")
                  for t in like)))


def _fp_migrate_case(torch, K, F, ck, dev, name, keys, old, n_shards: int,
                     chunk: int, case: str, first: bool) -> None:
    """Growth's table form from ``old`` (a CPU table) into twice its size,
    on the card and in the plain version (JAX's passes, chunks of
    ``chunk`` a region): every entry placed on both sides, one launch a
    pass, the card's table held by key and by the invariants; then one
    launch timed into a zeroed table (the zeroing untimed, printed on its
    own line)."""
    from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
        migrate_passes,
    )

    n_new = 2 * old[0].shape[0]
    cls = type(old[1])
    entries = int((old[0] != 0).any(1).sum())
    old_d = _fp_copy(old, dev)
    new_c = _fp_fresh(torch, F, cls, n_new, old[1])
    new_d = _fp_fresh(torch, F, cls, n_new, old[1], dev)
    geometry = dict(probe_window=FP_L, rounds=FP_R, n_shards=n_shards,
                    chunk=chunk)
    t = time.perf_counter()
    left_c, _ = migrate_passes(*new_c, *old, **geometry)
    plain_s = time.perf_counter() - t
    l0 = ck.launches[name]
    t = time.perf_counter()
    left_d, _ = migrate_passes(*new_d, *old_d, **geometry)
    card_s = time.perf_counter() - t
    # The stores' own pass loop: on the card a pass is one launch.
    passes_d = ck.launches[name] - l0
    if left_c or left_d or passes_d != 1:
        raise AssertionError(f"{name} ({case}): {left_d} rows left on the "
                             f"card in {passes_d} launches, {left_c} in the "
                             "plain version")
    n_cells, err = _fp_same_by_key(F, f"{name} ({case})", new_c, new_d, keys,
                                   n_shards)
    if n_cells != entries:
        raise AssertionError(f"{name} ({case}): {n_cells} of {entries} "
                             "placed")
    probe = _fp_fresh(torch, F, cls, n_new, old[1], dev)

    def zero():
        probe[0].zero_()
        for col in probe[1]:
            col.zero_()

    def call():
        return ck.fp_migrate_table(*probe, *old_d, probe_window=FP_L,
                                   n_shards=n_shards)
    row = _fp_time(torch, name, call, setup=zero)
    zero_ms = _median_ms(zero, reps=10, warmup=2)
    state_b = 9 if cls is K.BucketState else 13
    row.update(plain_ms=plain_s * 1e3, card_passes=passes_d,
               card_wall_s=card_s, zero_ms=zero_ms)
    # Bytes: every old cell read once; for each entry (a live cell) its
    # state read, its window, the CAS's 8 B and its state written. The
    # kernel reads no empty cell's state. The new table's zeroing (every
    # new cell and its state written once) is counted on its own.
    old_n = old[0].shape[0]
    nbytes = old_n * 8 + entries * (state_b + FP_L * 8 + 8 + state_b)
    _fp_record(name, case, row, err, nbytes, FP_L * entries + old_n, first)
    bound_ms = _bound_ms(nbytes, 0)[0]
    zero_bound = _bound_ms(n_new * (8 + state_b), 0)[0]
    print(f"{name} {case}: {entries} entries in {passes_d} launch(es) on "
          f"the card ({card_s:.3f} s wall with the readback), equal to "
          f"plain by key, every entry placed (plain: {plain_s:.2f} s); "
          f"a launch {row['ms']:.4f} ms (device "
          f"{row['device_ms']} ms, bound {bound_ms:.4f} ms)")
    print(f"{name} {case}: zeroing the {n_new}-cell table {zero_ms:.4f} ms "
          f"(bound {zero_bound:.4f} ms), not in the launch's time")


def fp_kernel_cases(torch, K, F, ck, dev, rng) -> None:
    """Each fp entry point against its plain version on 2^24-slot tables
    (a 2^22 → 2^23 migration), by key and by the table's invariants; fills
    :data:`FP_RESULTS`."""
    cap, rate = FP_CAP, FP_RATE / 1024
    now = 1 << 20
    tables = {}
    for kind in ("bucket", "window"):
        keys, base = _fp_base(torch, K, F, rng, FP_SLOTS, FP_PRESENT, kind)
        tables[kind] = (keys, base, _fp_copy(base, dev))

    # -- the decision: K = 1 (the flush) and the store's chunk K = 8 x 4096.
    cases = [("bucket", 1, b, d, True) for b in (8, 64, BATCH)
             for d in ("zipf", "distinct")]
    cases += [(p, 1, b, "zipf", True) for p in ("sliding", "fixed")
              for b in (64, BATCH)]
    # The flush form's bit planes (the bulk lane's verdict-only one-batch
    # calls): every row sets or clears its own bits.
    cases += [(p, 1, BATCH, "zipf", False)
              for p in ("bucket", "sliding", "fixed")]
    cases += [(p, 8, BATCH, d, f) for p in ("bucket", "sliding", "fixed")
              for d in ("distinct", "zipf") for f in (True, False)]
    for policy, k, b, dist, f32 in cases:
        kind = "bucket" if policy == "bucket" else "window"
        keys, base, base_d = tables[kind]
        rows = _fp_rows(rng, keys, k * b, dist)
        counts = rng.integers(0, 4, k * b).astype(np.int64)
        counts[rng.random(k * b) < 0.02] = -1  # padding rows
        fused = F.pack_fp12(rows, np.zeros(0))
        fused[:, 2] = counts.astype(np.uint32)
        op = torch.from_numpy(fused.view(np.int32).reshape(k, b, 3))
        nows = torch.from_numpy((now + 37 * np.arange(k)).astype(np.int32))
        cpu, card = _fp_copy(base), _fp_copy(base_d)
        op_d, nows_d = op.to(dev), nows.to(dev)
        if policy == "bucket":
            name = "fp_decide"

            def call(t, o, nw, f32=f32):
                return ck.fp_acquire_scan(*t, o, nw, cap, rate,
                                          with_remaining=f32)
        else:
            name = "fp_window_decide"

            def call(t, o, nw, f32=f32, sliding=policy == "sliding"):
                return ck.fp_window_scan(*t, o, nw, FP_WLIMIT, 1024,
                                         interpolate=sliding,
                                         with_remaining=f32)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = call(card, op_d, nows_d)
        end.record()
        end.synchronize()
        cold_ms = start.elapsed_time(end)
        want = call(cpu, op, nows)
        g, w = got.cpu().numpy(), want.numpy()
        if f32:
            if not np.array_equal(g[:, 0], w[:, 0]):
                raise AssertionError(f"{name} {policy} K={k} B={b} {dist}: "
                                     "grant/resolve codes differ")
            err = float(np.abs(g[:, 1].astype(np.float64) - w[:, 1]).max())
            if not err <= ATOL:
                raise AssertionError(f"{name}: remaining err {err}")
            unresolved = int((w[:, 0] < 2).sum())
        else:
            if not np.array_equal(g, w):
                raise AssertionError(f"{name} {policy} K={k} B={b} {dist}: "
                                     "bit planes differ")
            err = 0.0
            unresolved = int((np.unpackbits(w[:, 1].reshape(-1)) == 0).sum())
        if unresolved:
            raise AssertionError(f"{name}: {unresolved} rows unresolved at "
                                 "a load far below the limit")
        cells, serr = _fp_same_by_key(F, f"{name} {policy} K={k} B={b}", cpu,
                                      card, np.concatenate([rows,
                                                            keys[:100_000]]))
        err = max(err, serr)
        first = (policy in ("bucket", "sliding") and k == 8 and f32
                 and dist == "distinct")
        row = _fp_time(torch, name, lambda: call(card, op_d, nows_d),
                       (lambda: call(cpu, op, nows)) if first else None)
        row["cold_ms"] = cold_ms
        rows_n = k * b
        d = len(np.unique(rows[counts >= 0].view(np.uint64)))
        claimed = cells - int((base[0] != 0).any(1).sum())
        state_b = 9 if kind == "bucket" else 13
        out_b = rows_n * 8 if f32 else rows_n // 4
        # Bytes: the 12 B operand row and the result of every row; for each
        # distinct valid key its window (L x 8 B) and its slot's state once
        # each way; an 8 B cell for each new key.
        nbytes = 12 * rows_n + out_b + (FP_L * 8 + 2 * state_b) * d \
            + 8 * claimed
        _fp_record(name, f"{policy} K={k} B={b} {dist} "
                   f"{'f32' if f32 else 'bits'}", row, err, nbytes,
                   FP_L * d + 12 * rows_n, first)
        print(f"{name} {policy} K={k} B={b} {dist} "
              f"{'f32' if f32 else 'bits'}: equal to plain by key "
              f"({cells} cells, max abs err {err!r}); cold {cold_ms:.4f} ms, "
              f"warm {row['ms']:.4f} ms (device {row['device_ms']} ms: "
              f"{_split_text(row)})")
        del cpu, card

    # -- window pressure: 8 x 4,096 new keys into a 2^16-slot table half
    #    full. On the card a row is unresolved only when its window is full;
    #    the plain version (JAX's R rounds, the last claimant winning) may
    #    leave a row unresolved beside a free cell. Held to the invariants.
    n_p = 1 << 16
    _, pbase = _fp_base(torch, K, F, rng, n_p, n_p // 2, "bucket")
    rows = _fp_keys(rng, 8 * BATCH)
    fused = F.pack_fp12(rows, np.zeros(0))
    fused[:, 2] = 1
    op = torch.from_numpy(fused.view(np.int32).reshape(8, BATCH, 3))
    nows = torch.full((8,), now, dtype=torch.int32)
    cpu, card = _fp_copy(pbase), _fp_copy(pbase, dev)
    got = ck.fp_acquire_scan(*card, op.to(dev), nows.to(dev), cap,
                             rate).cpu().numpy()
    want = ck.fp_acquire_scan(*cpu, op, nows, cap, rate).numpy()
    free_after = []
    for side, out, table in (("card", got, card[0].cpu()),
                             ("plain", want, cpu[0])):
        fp_t = table.numpy().view(np.uint32)
        F.check_table_np(fp_t, FP_L)
        code, rem = out[:, 0].reshape(-1), out[:, 1].reshape(-1)
        un = code < 2
        if code[un].any() or rem[un].any():
            raise AssertionError(f"window pressure ({side}): an unresolved "
                                 "row was granted or reads remaining > 0")
        if not (F.find_np(fp_t, rows[~un], FP_L) >= 0).all():
            raise AssertionError(f"window pressure ({side}): a resolved "
                                 "row's key holds no cell")
        cells_t = fp_t.view(np.uint64).reshape(-1)
        win = cells_t[F.base_index_np(rows[un], n_p, FP_L)[:, None]
                      + np.arange(FP_L)[None, :]]
        free_after.append((int(un.sum()), int((win == 0).any(1).sum())))
    if free_after[0][1]:
        raise AssertionError(f"window pressure: {free_after[0][1]} rows "
                             "unresolved on the card beside a free cell")
    print(f"fp_decide under window pressure (8 x {BATCH} new keys into "
          f"2^16 slots half full): card {free_after[0][0]} rows unresolved, "
          f"every one with its window full; plain version (JAX's rule, R = "
          f"{FP_R} rounds) {free_after[1][0]}, {free_after[1][1]} of them "
          "beside a free cell")
    del cpu, card, pbase

    # -- the debit: 4,096 rows with repeats and refunds; one valid row of 8.
    keys, base, base_d = tables["bucket"]
    for b, label in ((BATCH, "repeats and refunds"), (8, "one valid row")):
        rows = _fp_rows(rng, keys, b, "zipf")
        amounts = rng.integers(-3, 6, b).astype(np.float32)
        n_valid = 1 if b == 8 else b - b // 64
        packed = np.zeros((4, b), np.int32)
        packed[0, n_valid:] = -1
        packed[1] = amounts.view(np.int32)
        packed[2] = now
        packed[3, :n_valid] = F.fp_prefix_float(
            rows[:n_valid], amounts[:n_valid]).view(np.int32)
        kp = torch.from_numpy(rows.view(np.int32))
        cpu, card = _fp_copy(base), _fp_copy(base_d)
        kp_d = kp.to(dev)
        want = ck.fp_debit(*cpu, kp, torch.from_numpy(packed.copy()), cap,
                           rate).numpy()
        got = ck.fp_debit(*card, kp_d, torch.from_numpy(packed.copy()).to(
            dev), cap, rate).cpu().numpy()
        err = float(np.abs(got.astype(np.float64) - want).max())
        if not err <= ATOL:
            raise AssertionError(f"fp_debit ({label}): replies err {err}")
        cells, serr = _fp_same_by_key(F, f"fp_debit ({label})", cpu, card,
                                      np.concatenate([rows, keys[:100_000]]))
        packed_d = torch.from_numpy(packed).to(dev)
        row = _fp_time(torch, "fp_debit", lambda: ck.fp_debit(
            *card, kp_d, packed_d.clone(), cap, rate),
            (lambda: ck.fp_debit(*cpu, kp, torch.from_numpy(packed.copy()),
                                 cap, rate)) if b == BATCH else None)
        # Bytes: every row's pair, packed operand and reply; for each
        # distinct valid key its window and its state once each way.
        d = len(np.unique(rows[:n_valid].view(np.uint64)))
        _fp_record("fp_debit", f"{label} (B={b})", row, max(err, serr),
                   8 * b + 16 * b + 8 * b + (FP_L * 8 + 18) * d,
                   FP_L * d + 12 * b, b == BATCH)
        print(f"fp_debit B={b} ({label}): replies and state equal to plain "
              f"by key (max abs err {max(err, serr)!r}); {row['ms']:.4f} ms "
              f"(device {row['device_ms']} ms)")

    # -- the peek: 4,096 rows, half absent; it claims nothing.
    rows = _fp_rows(rng, keys, BATCH, "distinct")
    valid = torch.from_numpy(rng.random(BATCH) < 0.98)
    kp = torch.from_numpy(rows.view(np.int32))
    card = _fp_copy(base_d)
    kp_d, valid_d = kp.to(dev), valid.to(dev)
    want = ck.fp_peek(*base, kp, valid, now, cap, rate)
    got = ck.fp_peek(*card, kp_d, valid_d, now, cap, rate)
    _check_equal("fp_peek", got, want)
    if not torch.equal(card[0], base_d[0]):
        raise AssertionError("fp_peek claimed a cell")
    row = _fp_time(torch, "fp_peek", lambda: ck.fp_peek(
        *card, kp_d, valid_d, now, cap, rate),
        lambda: ck.fp_peek(*base, kp, valid, now, cap, rate))
    # Bytes: every row's pair, valid byte and reply; a valid row's window
    # (the rows are distinct); the state of the keys found.
    found = int(((F.find_np(base[0].numpy().view(np.uint32), rows, FP_L)
                  >= 0) & valid.numpy()).sum())
    n_valid = int(valid.sum())
    _fp_record("fp_peek", f"B={BATCH}", row, 0.0,
               9 * BATCH + 4 * BATCH + FP_L * 8 * n_valid + 9 * found,
               FP_L * n_valid + 8 * found, True)
    print(f"fp_peek B={BATCH}: equal to plain, no cell claimed; "
          f"{row['ms']:.4f} ms (device {row['device_ms']} ms)")
    # The shape of the store's peek_blocking: one valid row (a present key)
    # in a B = 8 operand.
    kp8 = np.zeros((8, 2), np.uint32)
    kp8[0] = keys[0]
    kp8 = torch.from_numpy(kp8.view(np.int32))
    valid8 = torch.zeros(8, dtype=torch.bool)
    valid8[0] = True
    kp8_d, valid8_d = kp8.to(dev), valid8.to(dev)
    _check_equal("fp_peek B=8", ck.fp_peek(*card, kp8_d, valid8_d, now, cap,
                                           rate),
                 ck.fp_peek(*base, kp8, valid8, now, cap, rate))
    row = _fp_time(torch, "fp_peek", lambda: ck.fp_peek(
        *card, kp8_d, valid8_d, now, cap, rate),
        lambda: ck.fp_peek(*base, kp8, valid8, now, cap, rate))
    # Bytes: 8 pairs, valid bytes and replies; one window and one state.
    nbytes8 = 9 * 8 + 4 * 8 + FP_L * 8 + 9
    _fp_record("fp_peek", "B=8, one valid row (peek_blocking)", row, 0.0,
               nbytes8, FP_L + 8)
    print(f"fp_peek B=8, one valid row (the shape of peek_blocking): equal "
          f"to plain; {row['ms']:.4f} ms (device {row['device_ms']} ms, "
          f"bound {_bound_ms(nbytes8, FP_L + 8)[0]:.7f} ms)")

    # -- the sweeps, at a tick that expires about half the table.
    for name, kind in (("fp_sweep", "bucket"), ("fp_sweep_windows",
                                                "window")):
        keys, base, base_d = tables[kind]
        if kind == "bucket":
            # TTL = max(deficit / rate, 1024 ticks): tokens uniform in
            # [0, 5) at 1/1024 a tick, idle since [now - 4096, now): ~3/8
            # expire.
            def sweep(t):
                return ck.fp_sweep_expired(*t, now, cap, rate)
        else:
            # Indices now - 3 .. now: two whole windows behind for half.
            def sweep(t):
                return ck.fp_sweep_windows(*t, now, 1024)
        cpu, card = _fp_copy(base), _fp_copy(base_d)
        want = int(sweep(cpu)[0])
        got = int(sweep(card).cpu()[0])
        live = int((base[0] != 0).any(1).sum())
        if got != want or not 0.25 * live < got < 0.75 * live:
            raise AssertionError(f"{name}: freed {got}, plain {want}, of "
                                 f"{live} live")
        _check_equal(f"{name} cells", card[0], cpu[0])
        for a, b2 in zip(card[1], cpu[1]):
            _check_equal(f"{name} state", a, b2)
        row = _fp_time(torch, name, lambda: sweep(card),
                       lambda: sweep(cpu))
        # Bytes: exists for every slot; the rule's columns of the live
        # slots only (tokens and last_ts, or window_idx); exists and the
        # 8 B cell written for each freed slot.
        rule_b = 8 if kind == "bucket" else 4
        _fp_record(name, f"N=2^24, {got} of {live} freed", row, 0.0,
                   FP_SLOTS + rule_b * live + 9 * got,
                   FP_SLOTS + 8 * live, True)
        print(f"{name} over 2^24 slots: {got} of {live} freed, table equal "
              f"to plain; {row['ms']:.4f} ms (device {row['device_ms']} ms)")
        del cpu, card

    # -- the migrate: growth's table form, a 2^22-slot table's entries into
    #    2^23 slots, one launch a pass on the card, against its plain version
    #    (JAX's passes, chunks of 4,096); then the chunked replay growth ran
    #    before (a launch and a readback a chunk of 4,096), the before
    #    figure on the same entries.
    for name, kind in (("fp_migrate", "bucket"), ("fp_migrate_window",
                                                  "window")):
        keys, old = _fp_base(torch, K, F, rng, FP_MIGRATE_FROM,
                             FP_MIGRATE_ENTRIES, kind)
        _fp_migrate_case(torch, K, F, ck, dev, name, keys, old, 1, BATCH,
                         f"table 2^22 -> 2^23, {kind}", True)
        # The chunked replay (chunk form, the same kernel), held by key to
        # the old table.
        cells = np.nonzero((old[0] != 0).any(1).numpy())[0]
        old_d = _fp_copy(old, dev)
        new_d = _fp_fresh(torch, F, type(old[1]), 2 * FP_MIGRATE_FROM,
                          old[1], dev)
        launches, retried = 0, 0
        t = time.perf_counter()
        pend = cells
        for _ in range(8):
            nxt = []
            for i in range(0, len(pend), BATCH):
                idx = pend[i:i + BATCH]
                ix = torch.from_numpy(idx).to(dev)
                placed = ck.fp_migrate(
                    *new_d, old_d[0][ix].contiguous(),
                    [c[ix] for c in old_d[1]],
                    torch.ones(len(idx), dtype=torch.bool, device=dev))
                nxt.append(idx[~placed.cpu().numpy()])
                launches += 1
            pend = np.concatenate(nxt)
            retried += len(pend)
            if not len(pend):
                break
        whole_s = time.perf_counter() - t
        if len(pend):
            raise AssertionError(f"{name}: the chunked replay left "
                                 f"{len(pend)} rows after eight passes")
        n_cells, _ = _fp_same_by_key(F, f"{name} (chunked replay)", old,
                                     new_d, keys)
        if n_cells != len(cells):
            raise AssertionError(f"{name} (chunked replay): {n_cells} of "
                                 f"{len(cells)} placed")
        r = FP_RESULTS[name]["shapes"][f"table 2^22 -> 2^23, {kind}"]
        r.update(chunked_replay_s=whole_s, chunked_replay_launches=launches,
                 chunked_replay_retried=retried)
        print(f"{name} chunked replay (the growth loop before, chunk form "
              f"B={BATCH}): {len(cells)} entries in {launches} launches "
              f"and readbacks, {retried} rows in a later pass, "
              f"{whole_s:.3f} s wall, equal by key")
        del old, old_d, new_d
    del tables
    torch.cuda.empty_cache()


async def _fp_bulk(store, keys, counts, with_remaining=True, window=None):
    """``keys`` through ``acquire_many`` (or ``window_acquire_many`` with
    ``window = fixed``) in calls of :data:`FP_CALL`; the concatenated
    results and the wall seconds."""
    g, r = [], []
    t = time.perf_counter()
    for i in range(0, len(keys), FP_CALL):
        ks, cs = keys[i:i + FP_CALL], counts[i:i + FP_CALL]
        if window is None:
            res = await store.acquire_many(ks, cs, FP_CAP, FP_RATE,
                                           with_remaining=with_remaining)
        else:
            res = await store.window_acquire_many(
                ks, cs, FP_WLIMIT, FP_WINDOW_S, fixed=window,
                with_remaining=with_remaining)
        g.append(res.granted)
        if with_remaining:
            r.append(res.remaining)
    wall = time.perf_counter() - t
    return (np.concatenate(g), np.concatenate(r) if r else None), wall


async def _fp_cold_equal(what, store, keys, counts, got, want, unresolved,
                         window=None) -> int:
    """A cold pass (fresh keys, counts within the limit: the host store
    grants every row) held to the host directory's, without retries. A row
    may differ only where the fp store left it unresolved — on the card
    only a full window does — denied with remaining 0; the rows that differ
    must be exactly the ``unresolved`` the store counted. They are then
    sent again, once, as a client retries, into the table the store
    relieved, and must equal the host's. Returns their number."""
    lost = np.flatnonzero(got[0] != want[0])
    if (len(lost) != unresolved or got[0][lost].any()
            or np.any(got[1][lost] != 0)):
        raise AssertionError(
            f"{what}: {len(lost)} grants differ from the host directory's, "
            f"the store counted {unresolved} rows unresolved")
    keep = np.ones(len(got[0]), bool)
    keep[lost] = False
    _fp_equal(what, (got[0][keep], got[1][keep]),
              (want[0][keep], want[1][keep]))
    if len(lost):
        again, _ = await _fp_bulk(store, [keys[j] for j in lost],
                                  counts[lost], window=window)
        _fp_equal(f"{what}, the unresolved rows sent again", again,
                  (want[0][lost], want[1][lost]))
    return len(lost)


def _fp_equal(what, got, want) -> None:
    if not np.array_equal(got[0], want[0]):
        raise AssertionError(f"{what}: {int((got[0] != want[0]).sum())} "
                             "grants differ")
    if got[1] is not None and not np.array_equal(got[1], want[1]):
        err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
        raise AssertionError(f"{what}: remaining differs (max {err})")


async def fp_path(torch, ck, pkg, card: str) -> dict:
    """The fingerprint store on the card: the kernel cases, then (counts
    reset) 10M keys through ``FingerprintBucketStore(n_slots=2^24)``
    against a host-directory card store, growth, the window tier, a
    snapshot round trip, a sweep, the debit, and ``--directory fp`` as a
    subprocess. Returns the launches of the store part."""
    from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
    from distributedratelimiting.redis_tpu_torch.runtime import fp_store

    rng = np.random.default_rng(FP_SEED + 1)
    if not FP_RESULTS and not _KERNEL_CASES_RAN:
        # The path alone; the whole script ran them first.
        _fp_kernel_phase(torch, ck, card)

    # The host hash: timed, and the Python FNV must never run.
    hash_s, py_hashes = [0.0], [0]
    real_fp, real_py = fp_store.fingerprints, fp_store._fp64_py

    def timed_fps(keys):
        t = time.perf_counter()
        try:
            return real_fp(keys)
        finally:
            hash_s[0] += time.perf_counter() - t

    def counted_py(key):
        py_hashes[0] += 1
        return real_py(key)

    fp_store.fingerprints, fp_store._fp64_py = timed_fps, counted_py
    ck.reset_launches()
    try:
        lines = await _fp_store_part(torch, ck, pkg, F, rng, hash_s)
    finally:
        fp_store.fingerprints, fp_store._fp64_py = real_fp, real_py
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    if py_hashes[0]:
        raise AssertionError(f"fp path: {py_hashes[0]} keys took the Python "
                             "hash (the native directory library is not "
                             "loaded)")
    lines.append("native hash: every key (0 through the Python FNV)")
    for line in lines:
        print(f"fp path ({card}): {line}")
    # The console server with the fingerprint directory, in a thread: its
    # client runs an event loop of its own.
    await asyncio.to_thread(cli_server, pkg, "--directory", "fp")
    torch.cuda.empty_cache()
    return counts


async def _fp_store_part(torch, ck, pkg, F, rng, hash_s) -> list:
    from distributedratelimiting.redis_tpu_torch.runtime import fp_store

    lines = []
    clock = pkg.ManualClock(1_000_000)
    fp = pkg.FingerprintBucketStore(device="cuda", n_slots=FP_SLOTS,
                                    max_batch=BATCH, clock=clock)
    host = pkg.DeviceBucketStore(device="cuda", n_slots=FP_SLOTS,
                                 max_batch=BATCH, clock=clock)
    await fp.connect()
    await host.connect()
    keys = [f"fp{i}" for i in range(FP_KEYS)]
    counts = rng.integers(1, 4, FP_KEYS)
    # Cold: every key claims its cell; warm: every key probes.
    got, fp_cold = await _fp_bulk(fp, keys, counts)
    cold_hash = hash_s[0]
    cold_unresolved, cold_grows = fp.metrics.fp_unresolved, \
        fp.metrics.pregrows
    want, host_cold = await _fp_bulk(host, keys, counts)
    await _fp_cold_equal("10M keys, cold", fp, keys, counts, got, want,
                         cold_unresolved)
    cold_grows = fp.metrics.pregrows
    counts2 = rng.integers(1, 4, FP_KEYS)
    got, fp_warm = await _fp_bulk(fp, keys, counts2, with_remaining=False)
    want, host_warm = await _fp_bulk(host, keys, counts2,
                                     with_remaining=False)
    _fp_equal("10M keys, warm", got, want)
    denied = int((~got[0]).sum())
    # The device time of one warm call of 1M keys.
    call_keys, call_counts = keys[:FP_CALL], [0] * FP_CALL
    dev_ms = _device_ms(lambda: fp.acquire_many_blocking(
        call_keys, call_counts, FP_CAP, FP_RATE, with_remaining=False),
        FP_KERNEL_NAMES["fp_decide"], reps=3)
    before = hash_s[0]
    fp_store.fingerprints(call_keys)
    one_hash = hash_s[0] - before
    m = fp.metrics
    if (m.fp_unresolved, m.pregrows) != (cold_unresolved, cold_grows):
        raise AssertionError("10M keys: the warm pass (probes only) left "
                             "rows unresolved")
    lines.append(
        f"10M keys in calls of 1M, cold pass {cold_unresolved} rows "
        f"unresolved (full windows; denied, then sent again once), "
        f"{cold_grows} growths (table "
        f"{fp._table(FP_CAP, FP_RATE).n_slots} slots); grants and "
        f"remaining equal to the host "
        f"directory's: fp store cold {FP_KEYS / fp_cold:.0f} rows/s, warm "
        f"{FP_KEYS / fp_warm:.0f} rows/s; host directory cold "
        f"{FP_KEYS / host_cold:.0f}, warm {FP_KEYS / host_warm:.0f}; "
        f"{denied} denied warm; the host hash {cold_hash:.2f} s of the cold "
        f"pass ({one_hash * 1e3:.1f} ms a 1M call) beside the kernels' "
        f"{dev_ms} ms a 1M call")
    # Peeks of sampled keys; the debit with refunds.
    sample = [keys[i] for i in rng.permutation(FP_KEYS)[:FP_PEEKS]]
    pf = [fp.peek_blocking(k, FP_CAP, FP_RATE) for k in sample]
    ph = [host.peek_blocking(k, FP_CAP, FP_RATE) for k in sample]
    if pf != ph:
        raise AssertionError("fp path: peeks differ from the host store's")
    amounts = rng.integers(-2, 4, FP_DEBIT_KEYS).astype(float)
    dk = [keys[i] for i in rng.permutation(FP_KEYS)[:len(amounts)]]
    a = await fp.debit_many(dk, amounts, FP_CAP, FP_RATE)
    b = await host.debit_many(dk, amounts, FP_CAP, FP_RATE)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError("fp path: debit replies differ")
    lines.append(f"{FP_PEEKS} peeks and a debit of {len(dk)} keys (refunds "
                 "included) equal to the host directory's")

    # The window tier, sliding and fixed, at the same scale.
    for fixed in (False, True):
        wc = rng.integers(1, 3, FP_KEYS)
        before = fp.metrics.fp_unresolved
        got, fw = await _fp_bulk(fp, keys, wc, window=fixed)
        wres = fp.metrics.fp_unresolved - before
        want, hw = await _fp_bulk(host, keys, wc, window=fixed)
        await _fp_cold_equal(f"window ({'fixed' if fixed else 'sliding'})",
                             fp, keys, wc, got, want, wres, window=fixed)
        lines.append(f"{'fixed' if fixed else 'sliding'} window, 10M keys: "
                     f"equal to the host directory's ({wres} rows sent "
                     f"again); {FP_KEYS / fw:.0f} "
                     f"rows/s (host directory {FP_KEYS / hw:.0f})")

    # The snapshot round trip at 10M keys.
    pf = [fp.peek_blocking(k, FP_CAP, FP_RATE) for k in sample]
    t = time.perf_counter()
    snap = fp.snapshot()
    t_save = time.perf_counter() - t
    fresh = pkg.FingerprintBucketStore(device="cuda", n_slots=1 << 16,
                                       max_batch=BATCH,
                                       clock=pkg.ManualClock(
                                           clock.now_ticks()))
    t = time.perf_counter()
    fresh.restore(snap)
    t_load = time.perf_counter() - t
    del snap
    if [fresh.peek_blocking(k, FP_CAP, FP_RATE) for k in sample] != pf:
        raise AssertionError("fp path: peeks differ after the round trip")
    lines.append(f"snapshot of 10M keys {t_save:.1f} s, restored in "
                 f"{t_load:.1f} s, {FP_PEEKS} peeks equal")
    await fresh.aclose()
    del fresh

    # A day later every slot expires: the sweeps free them all, as the host
    # directory's do.
    clock.advance_seconds(86_400.0)
    e0, h0 = fp.metrics.slots_evicted, host.metrics.slots_evicted
    fp.sweep_all()
    host.sweep_all()
    fe = fp.metrics.slots_evicted - e0
    he = host.metrics.slots_evicted - h0
    if fe != he or fe < 3 * FP_KEYS:
        raise AssertionError(f"fp path: the sweep freed {fe}, the host "
                             f"store {he}")
    if int((fp._table(FP_CAP, FP_RATE).fp != 0).any(1).sum()):
        raise AssertionError("fp path: cells left after the sweep")
    lines.append(f"a day later sweep_all freed {fe} slots and every cell, "
                 "as the host directory's")
    await fp.aclose()
    await host.aclose()
    del fp, host, keys
    torch.cuda.empty_cache()

    # Growth: a 2^20-slot store fed 2M keys (buckets and sliding windows);
    # a row denied for window pressure is sent again, as a caller retries.
    gclock = pkg.ManualClock(1_000_000)
    grow = pkg.FingerprintBucketStore(device="cuda", n_slots=FP_GROW_SLOTS,
                                      max_batch=BATCH, clock=gclock)
    ghost = pkg.DeviceBucketStore(device="cuda", n_slots=FP_GROW_SLOTS,
                                  max_batch=BATCH, clock=gclock)
    gkeys = [f"g{i}" for i in range(FP_GROW_KEYS)]
    # Each growth's wall seconds, and the store lock's longest hold during
    # the pressure relief that ran it (the sweep and the growth: the
    # serving stall).
    from distributedratelimiting.redis_tpu_torch.runtime import fp_store
    timer = grow._lock = _HoldTimer(grow._lock)
    real_grow = fp_store._FpTable._grow
    real_relieve = fp_store._FpTable._relieve_pressure
    grow_s, grow_holds = [], []

    def timed_grow(self):
        t = time.perf_counter()
        try:
            real_grow(self)
        finally:
            grow_s.append(time.perf_counter() - t)

    def timed_relieve(self):
        n0, longest = len(grow_s), timer.longest
        timer.longest = 0.0
        try:
            real_relieve(self)
        finally:
            if len(grow_s) > n0:
                grow_holds.append(timer.longest)
            timer.longest = max(timer.longest, longest)

    fp_store._FpTable._grow = timed_grow
    fp_store._FpTable._relieve_pressure = timed_relieve
    try:
        lines += await _fp_grow_traffic(grow, ghost, gkeys)
    finally:
        fp_store._FpTable._grow = real_grow
        fp_store._FpTable._relieve_pressure = real_relieve
    if len(grow_s) != grow.metrics.pregrows or len(grow_holds) != len(grow_s):
        raise AssertionError(f"growth: {len(grow_s)} growths timed, "
                             f"{grow.metrics.pregrows} counted")
    lines.append(f"growth: {len(grow_s)} growths, wall s each "
                 f"{[round(x, 4) for x in grow_s]}; the store lock's longest "
                 f"hold during each {[round(x, 4) for x in grow_holds]}")
    gs = [gkeys[i] for i in rng.permutation(FP_GROW_KEYS)[:FP_PEEKS]]
    if ([grow.peek_blocking(k, FP_CAP, FP_RATE) for k in gs]
            != [ghost.peek_blocking(k, FP_CAP, FP_RATE) for k in gs]):
        raise AssertionError("growth: peeks differ from the host store's")
    more = await grow.window_acquire_many(gs, [FP_WLIMIT] * len(gs),
                                          FP_WLIMIT, FP_WINDOW_S)
    want = await ghost.window_acquire_many(gs, [FP_WLIMIT] * len(gs),
                                           FP_WLIMIT, FP_WINDOW_S)
    if not np.array_equal(more.granted, want.granted):
        raise AssertionError("growth: window state differs after growth")
    lines.append(f"growth: pregrows {grow.metrics.pregrows}, "
                 f"fp_unresolved {grow.metrics.fp_unresolved}; {FP_PEEKS} "
                 "peeks and the windows' next grants equal to the host "
                 "directory's")
    await grow.aclose()
    await ghost.aclose()
    return lines


async def _fp_grow_traffic(grow, ghost, gkeys) -> list:
    """The growth case's traffic: 2M keys into 2^20 slots, buckets then
    sliding windows, rows denied for window pressure sent again; the host
    store takes the same keys."""
    lines = []
    for window in (None, False):
        retried = 0
        for i in range(0, FP_GROW_KEYS, FP_GROW_CALL):
            ks = gkeys[i:i + FP_GROW_CALL]
            pending = ks
            for _ in range(6):
                if window is None:
                    r = await grow.acquire_many(pending, [1] * len(pending),
                                                FP_CAP, FP_RATE)
                else:
                    r = await grow.window_acquire_many(
                        pending, [1] * len(pending), FP_WLIMIT, FP_WINDOW_S)
                pending = [k for k, g in zip(pending, r.granted) if not g]
                if not pending:
                    break
                retried += len(pending)
            if pending:
                raise AssertionError(f"growth: {len(pending)} rows still "
                                     "denied after retries")
            if window is None:
                await ghost.acquire_many(ks, [1] * len(ks), FP_CAP, FP_RATE)
            else:
                await ghost.window_acquire_many(ks, [1] * len(ks), FP_WLIMIT,
                                                FP_WINDOW_S)
        table = (grow._table(FP_CAP, FP_RATE) if window is None
                 else grow._wtable(FP_WLIMIT, FP_WINDOW_S))
        lines.append(f"growth ({'bucket' if window is None else 'window'}):"
                     f" 2M keys into 2^20 slots, {retried} rows retried, "
                     f"table now {table.n_slots} slots")
    if grow.metrics.pregrows < 2:
        raise AssertionError(f"growth: pregrows {grow.metrics.pregrows}")
    return lines


# -- the mesh (parallel/): the key-sharded store on one card ------------------
MESH_SEED = 1818
#: BASELINE.json config 5: 10M keys sharded over 8 shards, here all on one
#: card (2^21 slots a shard, 2^24 in all: the bucket state is ~150 MB).
MESH_SHARDS = 8
MESH_PER_SHARD = 2**21
MESH_KEYS = 10_000_000
MESH_CALL = 1_000_000
MESH_T0 = 1_000_000
MESH_WIRE_KEYS = 1_000_000
MESH_WIRE_SCALAR_KEYS = 800  # x 5 asks at capacity 3: 4,000 requests
MESH_WIRE_ASKS = 5
MESH_WIRE_CAP = 3.0
MESH_PEEKS = 10_000
#: The global tier's cases, (K, R): the bulk chunk at 8 shards (16 x 8 x
#: 1,024) first, then a flush's K = 1 at 8 rows and at a decision batch,
#: and wider launches.
MESH_TIER_SHAPES = ((16, 8192), (1, 8), (1, 8192), (8, 8192), (32, 4096),
                    (1, 65536))
#: The mesh's kernel results for the kernels line.
MESH_RESULTS: dict = {}


def _device_ms_by(fn, groups: dict, reps=3) -> dict:
    """Device ms per call of each named group of CUDA kernels, from one
    ``torch.profiler`` trace of ``reps`` calls (``None`` where the trace
    holds no device time for a group)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for group, names in groups.items():
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                 if any(k in e.key for k in names))
        out[group] = us / 1e3 / reps if us > 0 else None
    return out


def fp_bench() -> int:
    """``python3 chip_smoke.py --fp-bench [JSON]``: only the fp and mesh
    kernel cases (:func:`fp_kernel_cases`, :func:`mesh_kernel_cases`), on
    the package beside this file (copy the script into another checkout to
    time that checkout's kernels). Prints the card, every case's line and
    the fp kernels' ``-Xptxas -v`` lines; writes each fp wrapper's timed
    shapes (event ms, device ms and its split by kernel) to ``JSON``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

    card = _card_line()
    print(card)
    report = ck.build(["fp_directory", "acquire", "window", "admission",
                       "mesh"])
    for name in ("fp_directory", "acquire", "window"):
        lines = report[name]["log"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    k in line for k in ("resolve", "migrate", "scan_kernel",
                                        "fp_flush")):
                print(f"{name}: {line.strip()} | "
                      + " | ".join(x.strip() for x in lines[i + 1:i + 3]))
    _fp_kernel_phase(torch, ck, card)
    _mesh_kernel_phase(torch, ck, card)
    if FP_C1:
        print(f"ROADMAP C1: {len(FP_C1)} timed fp calls without device time")
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump({"card": card, "c1": FP_C1, "fp": FP_RESULTS,
                       "mesh": MESH_RESULTS}, f, indent=1, default=str)
    return 0


def _mesh_kernel_phase(torch, ck, card: str) -> None:
    """The mesh's kernel cases, timed, in a process that has run no path
    yet (ROADMAP C1, as the fp cases)."""
    from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    mesh_kernel_cases(torch, K, F, ck, torch.device("cuda"),
                      np.random.default_rng(MESH_SEED))
    print(f"mesh kernel cases ({card}): {time.perf_counter() - t0:.1f} s")


def mesh_kernel_cases(torch, K, F, ck, dev, rng) -> None:
    """``global_tier`` against its plain version at :data:`MESH_TIER_SHAPES`,
    both cadences, fresh and live counters (equal bit for bit: whole counts);
    the fp kernels with 8 shard regions against theirs, by key. Fills
    :data:`MESH_RESULTS` and adds shapes to :data:`FP_RESULTS`."""
    rate = 1.0 / 1024
    for i, (k, r) in enumerate(MESH_TIER_SHAPES):
        out = np.zeros((k, 2, r), np.float32)
        out[:, 0] = rng.random((k, r)) < 0.7
        counts = rng.integers(0, 4, (k, r)).astype(np.int32)
        counts[rng.random((k, r)) < 0.02] = 0  # padding rows
        nows = (MESH_T0 + np.cumsum(rng.integers(0, 64, k))).astype(np.int32)
        out_t, counts_t, nows_t = (torch.from_numpy(a)
                                   for a in (out, counts, nows))
        out_d, counts_d, nows_d = (t.to(dev) for t in (out_t, counts_t,
                                                        nows_t))
        for cadence in ("batch", "launch"):
            for live in (False, True):
                gc_, gd = K.init_global_counter(), K.init_global_counter(dev)
                if live:
                    for g in (gc_, gd):
                        g.value.fill_(123_456.0)
                        g.period.fill_(500.25)
                        g.last_ts.fill_(MESH_T0 - 3000)
                        g.exists.fill_(True)
                K.global_tier(out_t, counts_t, nows_t, gc_, rate, cadence)
                ck.global_tier(out_d, counts_d, nows_d, gd, rate, cadence)
                got = [t.item() for t in gd]
                want = [t.item() for t in gc_]
                if got != want:
                    raise AssertionError(f"global_tier K={k} R={r} "
                                         f"{cadence}: {got} != {want}")
        gd = K.init_global_counter(dev)
        gc_ = K.init_global_counter()
        row = {"ms": _median_ms(lambda: ck.global_tier(
            out_d, counts_d, nows_d, gd, rate), reps=20),
            "device_ms": _device_ms(lambda: ck.global_tier(
                out_d, counts_d, nows_d, gd, rate), ["global_tier_kernel"]),
            "plain_ms": _median_ms(lambda: K.global_tier(
                out_t, counts_t, nows_t, gc_, rate), reps=3, warmup=1)}
        # Bytes: each row's grant (4 B) and count (4 B) read once, the
        # counter's 13 B each way, nows 4 B a batch; 2 integer ops a row.
        nbytes, ops = 8 * k * r + 26 + 4 * k, 2 * k * r
        bound_ms, bound_by = _bound_ms(nbytes, ops)
        res = MESH_RESULTS.setdefault("global_tier", {
            "max_abs_err": 0.0, "shapes": {}, "library_ms": None})
        res["shapes"][f"K={k} R={r}"] = dict(row, bound_ms=bound_ms,
                                             bound_by=bound_by,
                                             max_abs_err=0.0)
        if i == 0:
            res.update(ms=row["ms"], device_ms=row["device_ms"],
                       plain_ms=row["plain_ms"], bytes=nbytes, ops=ops)
        print(f"global_tier K={k} R={r}: equal to plain (both cadences, "
              f"fresh and live counters); {row['ms']:.4f} ms (device "
              f"{row['device_ms']} ms, bound {bound_ms:.6f} ms, plain "
              f"{row['plain_ms']:.3f} ms)")

    # -- the fp kernels with 8 shard regions: a 2^24-slot table (2^21 a
    #    region), the sharded store's launch of 8 batches of 8 x 512 rows.
    s_n, cap, now = MESH_SHARDS, FP_CAP, 1 << 20
    k, b = 8, s_n * 512
    for kind in ("bucket", "window"):
        keys, base = _fp_base(torch, K, F, rng, FP_SLOTS, FP_PRESENT, kind,
                              n_shards=s_n)
        base_d = _fp_copy(base, dev)
        rows = _fp_rows(rng, keys, k * b, "distinct")
        counts = rng.integers(0, 4, k * b).astype(np.int64)
        fused = F.pack_fp12(rows, counts)
        op = torch.from_numpy(fused.view(np.int32).reshape(k, b, 3))
        nows = torch.from_numpy(np.full(k, now, np.int32))
        cpu, card = _fp_copy(base), _fp_copy(base_d)
        if kind == "bucket":
            name = "fp_decide"

            def call(t, o, nw):
                return ck.fp_acquire_scan(*t, o, nw, cap, 1.0 / 1024,
                                          probe_window=FP_L, n_shards=s_n)
        else:
            name = "fp_window_decide"

            def call(t, o, nw):
                return ck.fp_window_scan(*t, o, nw, FP_WLIMIT, 1024,
                                         probe_window=FP_L, n_shards=s_n)
        got = call(card, op.to(dev), nows.to(dev)).cpu().numpy()
        want = call(cpu, op, nows).numpy()
        if not np.array_equal(got[:, 0], want[:, 0]):
            raise AssertionError(f"{name} (8 shard regions): codes differ")
        err = float(np.abs(got[:, 1].astype(np.float64) - want[:, 1]).max())
        if not err <= ATOL or int((want[:, 0] < 2).sum()):
            raise AssertionError(f"{name} (8 shard regions): err {err} or "
                                 "rows unresolved")
        cells, serr = _fp_same_by_key(F, f"{name} (8 shard regions)", cpu,
                                      card, np.concatenate([
                                          rows, keys[:100_000]]), s_n)
        if kind == "bucket":
            # The peek and the migrate in the regions, by key.
            kp = torch.from_numpy(rows[:b].view(np.int32).copy())
            valid = torch.ones(b, dtype=torch.bool)
            pc = ck.fp_peek(*cpu, kp, valid, now, cap, 1.0 / 1024,
                            probe_window=FP_L, n_shards=s_n)
            kp_d, valid_d = kp.to(dev), valid.to(dev)

            def peek():
                return ck.fp_peek(*card, kp_d, valid_d, now, cap, 1.0 / 1024,
                                  probe_window=FP_L, n_shards=s_n)
            if not torch.equal(pc, peek().cpu()):
                raise AssertionError("fp_peek (8 shard regions) differs")
            prow = _fp_time(torch, "fp_peek", peek)
            _fp_record("fp_peek", f"8 shard regions B={b}", prow, 0.0,
                       8 * b + b + 4 * b + (FP_L * 8 + 9) * b, FP_L * b)
            new_c = (F.init_fp_table(FP_SLOTS), K.init_bucket_state(FP_SLOTS))
            new_d = _fp_copy(new_c, dev)
            cols = [torch.from_numpy(rng.uniform(0, cap, b).astype(
                np.float32)), torch.full((b,), now, dtype=torch.int32),
                torch.ones(b, dtype=torch.bool)]
            cols_d = [c.to(dev) for c in cols]
            placed = ck.fp_migrate(*new_d, kp_d, cols_d, valid_d,
                                   probe_window=FP_L, n_shards=s_n)
            placed_c = ck.fp_migrate(*new_c, kp, cols, valid,
                                     probe_window=FP_L, n_shards=s_n)
            if not (placed.all() and placed_c.all()):
                raise AssertionError("fp_migrate (8 shard regions): rows "
                                     "not placed")
            _fp_same_by_key(F, "fp_migrate (8 shard regions)", new_c, new_d,
                            rows[:b], s_n)

            def migrate():
                fresh = (F.init_fp_table(FP_SLOTS, dev),
                         K.init_bucket_state(FP_SLOTS, dev))
                return ck.fp_migrate(*fresh, kp_d, cols_d, valid_d,
                                     probe_window=FP_L, n_shards=s_n)
            mrow = _fp_time(torch, "fp_migrate", migrate)
            _fp_record("fp_migrate", f"8 shard regions B={b}", mrow, 0.0,
                       8 * b + b + 9 * b + (FP_L * 8 + 9 + 8) * b, FP_L * b)
            # Growth's table form over 8 shard regions: a 2^22-slot table of
            # 1M entries into 2^23 slots in one launch; the plain version
            # takes the mesh tier's chunks, 512 rows a region.
            mkeys, mold = _fp_base(torch, K, F, rng, FP_MIGRATE_FROM,
                                   FP_MIGRATE_ENTRIES, "bucket", n_shards=s_n)
            _fp_migrate_case(torch, K, F, ck, dev, "fp_migrate", mkeys, mold,
                             s_n, 512, "table 2^22 -> 2^23, 8 shard regions",
                             False)
            del mold
        # Timed last: its repeated launches consume the card table's tokens.
        op_d, nows_d = op.to(dev), nows.to(dev)
        row = _fp_time(torch, name, lambda: call(card, op_d, nows_d))
        d = len(np.unique(rows.view(np.uint64)))
        state_b = 9 if kind == "bucket" else 13
        claimed = cells - int((base[0] != 0).any(1).sum())
        nbytes = 12 * k * b + 8 * k * b + (FP_L * 8 + 2 * state_b) * d \
            + 8 * claimed
        _fp_record(name, f"8 shard regions K={k} B={b}", row,
                   max(err, serr), nbytes, FP_L * d + 12 * k * b)
        print(f"{name} with 8 shard regions, K={k} x {b}: equal to plain by "
              f"key ({cells} cells); {row['ms']:.4f} ms (device "
              f"{row['device_ms']} ms: {_split_text(row)})")
        del cpu, card, base, base_d


async def _mesh_bulk(store, keys, counts, *, window=None,
                     with_remaining=True):
    """``keys`` through the store's bulk lane in calls of
    :data:`MESH_CALL`; the concatenated (grants, remaining) and the wall
    seconds."""
    g, r = [], []
    t = time.perf_counter()
    for i in range(0, len(keys), MESH_CALL):
        ks, cs = keys[i:i + MESH_CALL], counts[i:i + MESH_CALL]
        if window is None:
            res = await store.acquire_many(ks, cs, FP_CAP, FP_RATE,
                                           with_remaining=with_remaining)
        else:
            res = await store.window_acquire_many(
                ks, cs, FP_WLIMIT, FP_WINDOW_S, fixed=window,
                with_remaining=with_remaining)
        g.append(res.granted)
        if with_remaining:
            r.append(res.remaining)
    return ((np.concatenate(g), np.concatenate(r) if r else None),
            time.perf_counter() - t)


def _tier_oracle(passes) -> float:
    """The global tier's value in float64: each pass ``(consumed, decay)``
    decays the counter by ``decay`` (clamped at 0) and adds what it
    consumed (every call of a pass runs at one tick, so only its first
    recurrence decays)."""
    v = 0.0
    for consumed, decay in passes:
        v = max(0.0, v - decay) + consumed
    return v


def _check_tier(what, store, oracle: float, recurrences: int) -> float:
    """``global_score`` against the float64 oracle: each recurrence rounds
    at most three times (product, difference, sum) to float32, so the score
    lies within ``3 * recurrences`` spacings of the largest value."""
    got = store._sharded(FP_CAP, FP_RATE).global_score
    tol = 3 * recurrences * float(np.spacing(np.float32(max(oracle, 1.0))))
    if not abs(got - oracle) <= tol:
        raise AssertionError(f"{what}: global_score {got} against the "
                             f"float64 oracle {oracle} (tolerance {tol})")
    return got - oracle


async def mesh_client(pkg, addr) -> dict:
    """The mesh path's wire client, a process of its own as a client host:
    one bulk of :data:`MESH_WIRE_KEYS` distinct keys (all granted), then
    ``acquire_async`` through ``PartitionedRateLimiter`` over a coalescing
    ``RemoteBucketStore``, 64 tasks, :data:`MESH_WIRE_SCALAR_KEYS` keys x
    :data:`MESH_WIRE_ASKS` asks at capacity 3 (3 grants a key)."""
    cli = pkg.RemoteBucketStore(address=addr)
    keys = [f"wire{i}" for i in range(MESH_WIRE_KEYS)]
    t = time.perf_counter()
    res = await cli.acquire_many(keys, [1] * len(keys), FP_CAP, FP_RATE,
                                 with_remaining=False)
    bulk_s = time.perf_counter() - t
    lim = pkg.PartitionedRateLimiter(pkg.TokenBucketOptions(
        token_limit=int(MESH_WIRE_CAP), tokens_per_period=1,
        replenishment_period_s=1000.0, instance_name="mesh"), cli)
    asks = [k for k in range(MESH_WIRE_SCALAR_KEYS)
            for _ in range(MESH_WIRE_ASKS)]
    np.random.default_rng(MESH_SEED + 5).shuffle(asks)
    grants = np.zeros(MESH_WIRE_SCALAR_KEYS, np.int64)
    lat = []
    t = time.perf_counter()
    queue_ = list(asks)

    async def worker():
        while queue_:
            key = queue_.pop()
            t1 = time.perf_counter()
            lease = await lim.acquire_async(key)
            lat.append(time.perf_counter() - t1)
            grants[key] += lease.is_acquired

    await asyncio.gather(*(worker() for _ in range(SCALAR_TASKS)))
    scalar_s = time.perf_counter() - t
    await cli.aclose()
    return {"bulk_granted": int(np.count_nonzero(res.granted)),
            "bulk_s": bulk_s, "scalar_s": scalar_s,
            "requests": len(asks), "grants": np.unique(grants).tolist(),
            "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3}


async def mesh_path(torch, ck, pkg, card: str) -> dict:
    """BASELINE config 5 on one card: ``MeshBucketStore`` over a mesh of
    8 x ``cuda:0``, 2^21 slots a shard, 10M distinct keys in calls of 1M,
    against a single-table ``DeviceBucketStore`` (JAX's differential
    anchor) on the same keys and clock: both cadences, the window tiers
    (sliding and fixed), the fp directory (cold, then warm), a snapshot of
    the 10M-key store restored, the wire (a client process) and the console
    server with ``--backend mesh --sync-cadence launch``. Returns the
    launches of the store part."""
    from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh

    if not MESH_RESULTS and not _KERNEL_CASES_RAN:
        # The path alone; the whole script ran them first.
        _mesh_kernel_phase(torch, ck, card)
    ck.reset_launches()
    lines = await _mesh_store_part(torch, ck, pkg, Mesh(
        ["cuda"] * MESH_SHARDS), np.random.default_rng(MESH_SEED + 1))
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    for line in lines:
        print(f"mesh path ({card}): {line}")
    await asyncio.to_thread(cli_server, pkg, "--backend", "mesh",
                            "--sync-cadence", "launch")
    torch.cuda.empty_cache()
    return counts


async def _mesh_store_part(torch, ck, pkg, mesh, rng) -> list:
    lines = []
    keys = [f"mk{i}" for i in range(MESH_KEYS)]
    c1 = rng.integers(1, 4, MESH_KEYS)
    c2 = rng.integers(1, 4, MESH_KEYS)
    dt = 1024  # one second between the passes
    decay = dt * FP_RATE / 1024  # the tier decays at the fill rate

    def mesh_store(**kw):
        return pkg.MeshBucketStore(mesh, per_shard_slots=MESH_PER_SHARD,
                                   max_batch=BATCH,
                                   clock=pkg.ManualClock(MESH_T0), **kw)

    # The anchor: one table of 2^24 slots, two bucket passes, both windows.
    anchor = pkg.DeviceBucketStore(device="cuda", n_slots=FP_SLOTS,
                                   max_batch=BATCH,
                                   clock=pkg.ManualClock(MESH_T0))
    await anchor.connect()
    a1, a1_s = await _mesh_bulk(anchor, keys, c1)
    anchor.clock.advance_ticks(dt)
    a2, a2_s = await _mesh_bulk(anchor, keys, c2)
    wanted = {}
    for fixed in (False, True):
        wanted[fixed] = await _mesh_bulk(anchor, keys, c1, window=fixed)
    await anchor.aclose()
    del anchor
    torch.cuda.empty_cache()
    consumed1 = float((c1 * a1[0]).sum())
    consumed2 = float((c2 * a2[0]).sum())

    # Both cadences: grants and remaining equal to the anchor's, the tier
    # against its float64 oracle.
    rates = {}
    stores = {}
    for cadence in ("batch", "launch"):
        store = mesh_store(sync_cadence=cadence)
        await store.connect()
        tier = store._sharded(FP_CAP, FP_RATE)
        resolve_s = [0.0]
        _time_calls(tier, "_resolve_batch", resolve_s)
        l0 = ck.launches["global_tier"]
        got, s1 = await _mesh_bulk(store, keys, c1)
        _fp_equal(f"mesh ({cadence}), 10M keys, pass 1", got, a1)
        err1 = _check_tier(f"mesh ({cadence}), pass 1", store,
                           _tier_oracle([(consumed1, 0.0)]),
                           16 * (ck.launches["global_tier"] - l0))
        line = (f"{cadence} cadence, 10M keys in calls of 1M: grants and "
                f"remaining equal to the single table's; pass 1 "
                f"{MESH_KEYS / s1:.0f} rows/s (the single table "
                f"{MESH_KEYS / a1_s:.0f}), routing and resolve "
                f"{resolve_s[0]:.2f} s; global_score - oracle {err1!r}")
        if cadence == "batch":
            store.clock.advance_ticks(dt)
            got, s2 = await _mesh_bulk(store, keys, c2)
            _fp_equal("mesh (batch), 10M keys, pass 2", got, a2)
            err2 = _check_tier("mesh (batch), pass 2", store, _tier_oracle(
                [(consumed1, 0.0), (consumed2, decay)]),
                16 * (ck.launches["global_tier"] - l0))
            line += (f"; pass 2 {MESH_KEYS / s2:.0f} rows/s (single table "
                     f"{MESH_KEYS / a2_s:.0f}), global_score - oracle "
                     f"{err2!r}")
        rates[cadence] = MESH_KEYS / s1
        lines.append(line)
        stores[cadence] = store

    # The device time of one 1M call (probes: nothing granted), by kernel.
    call_keys, zeros = keys[:MESH_CALL], [0] * MESH_CALL
    for cadence, store in stores.items():
        dev = _device_ms_by(
            lambda: store.acquire_many_blocking(call_keys, zeros, FP_CAP,
                                                FP_RATE,
                                                with_remaining=False),
            {"decide": ["scan_kernel"], "tier": ["global_tier_kernel"]})
        lines.append(f"{cadence} cadence, a 1M-key call's device ms: "
                     f"decisions {dev['decide']}, global_tier {dev['tier']}")
    lines.append(f"launch against batch cadence: {rates['launch']:.0f} "
                 f"against {rates['batch']:.0f} rows/s "
                 f"({rates['launch'] / rates['batch'] - 1:+.1%})")

    # The window tiers on the batch store against the single table's.
    store = stores["batch"]
    for fixed in (False, True):
        got, ws = await _mesh_bulk(store, keys, c1, window=fixed)
        want, wa_s = wanted[fixed]
        _fp_equal(f"mesh window ({'fixed' if fixed else 'sliding'})", got,
                  want)
        lines.append(f"{'fixed' if fixed else 'sliding'} window tier, 10M "
                     f"keys: equal to the single table's; "
                     f"{MESH_KEYS / ws:.0f} rows/s (single table "
                     f"{MESH_KEYS / wa_s:.0f})")
    await store.aclose()
    del store, stores["batch"]
    torch.cuda.empty_cache()

    # A snapshot of the 10M-key store (launch cadence), restored.
    store = stores.pop("launch")
    sample = [keys[i] for i in rng.permutation(MESH_KEYS)[:MESH_PEEKS]]
    peeks = [store.peek_blocking(k, FP_CAP, FP_RATE) for k in sample]
    t = time.perf_counter()
    snap = store.snapshot()
    t_save = time.perf_counter() - t
    fresh = mesh_store()
    fresh.clock.set_ticks(store.clock.now_ticks())
    t = time.perf_counter()
    fresh.restore(snap)
    t_load = time.perf_counter() - t
    src, dst = store._sharded(FP_CAP, FP_RATE), fresh._sharded(FP_CAP,
                                                                FP_RATE)
    if not (all(torch.equal(a, b) for a, b in zip(src.state, dst.state))
            and all(torch.equal(a, b) for a, b in zip(src.gcounter,
                                                      dst.gcounter))):
        raise AssertionError("mesh snapshot: the restored state differs")
    if [fresh.peek_blocking(k, FP_CAP, FP_RATE) for k in sample] != peeks:
        raise AssertionError("mesh snapshot: peeks differ after restore")
    del snap
    lines.append(f"snapshot of the 10M-key store {t_save:.1f} s, restored in "
                 f"{t_load:.1f} s: state, counter and {MESH_PEEKS} peeks "
                 "equal")
    await fresh.aclose()
    await store.aclose()
    del fresh, store
    torch.cuda.empty_cache()

    # The fp directory: cold (claims; growth allowed, each growth timed),
    # then warm.
    from distributedratelimiting.redis_tpu_torch.parallel import fp_sharded
    fps = mesh_store(directory="fp")
    await fps.connect()
    real_grow = fp_sharded.ShardedFpDeviceStore._grow_locked
    grow_s = []

    def timed_grow(self):
        t = time.perf_counter()
        try:
            real_grow(self)
        finally:
            grow_s.append(time.perf_counter() - t)

    fp_sharded.ShardedFpDeviceStore._grow_locked = timed_grow
    try:
        got, f1 = await _mesh_bulk(fps, keys, c1)
    finally:
        fp_sharded.ShardedFpDeviceStore._grow_locked = real_grow
    tier = fps._sharded(FP_CAP, FP_RATE)
    if len(grow_s) != tier.grows:
        raise AssertionError(f"mesh fp: {len(grow_s)} growths timed, "
                             f"{tier.grows} counted")
    cold_unresolved, cold_grows = tier.fp_unresolved, tier.grows
    await _fp_cold_equal("mesh fp, 10M keys, cold", fps, keys, c1, got, a1,
                         cold_unresolved)
    fps.clock.advance_ticks(dt)
    u0 = tier.fp_unresolved
    got, f2 = await _mesh_bulk(fps, keys, c2)
    if tier.fp_unresolved != u0:
        raise AssertionError("mesh fp: the warm pass left rows unresolved")
    _fp_equal("mesh fp, 10M keys, warm", got, a2)
    lines.append(f"fp directory, 8 shard regions, 10M keys: cold "
                 f"{MESH_KEYS / f1:.0f} rows/s ({cold_unresolved} rows "
                 f"unresolved, sent again once; {cold_grows} growths to "
                 f"{tier.per_shard_slots} slots a shard, wall s each "
                 f"{[round(x, 4) for x in grow_s]}, the call's lock held "
                 "through each), warm "
                 f"{MESH_KEYS / f2:.0f} rows/s; decisions equal to the "
                 "single table's")
    await fps.aclose()
    del fps, tier
    torch.cuda.empty_cache()

    # The wire: a server over an 8-shard store, a client process.
    store = pkg.MeshBucketStore(mesh, per_shard_slots=2**18,
                                max_batch=BATCH,
                                clock=pkg.ManualClock(MESH_T0))
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0)
    host, port = await server.start()
    try:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, os.path.abspath(__file__), "--mesh-client", host,
            str(port), stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        try:
            out, err = await asyncio.wait_for(proc.communicate(), 600)
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"mesh client exited {proc.returncode}: "
                                 f"{err.decode()[-3000:]}")
        rep = json.loads(out.decode().strip().splitlines()[-1])
        if rep["bulk_granted"] != MESH_WIRE_KEYS or rep["grants"] != [
                int(MESH_WIRE_CAP)]:
            raise AssertionError(f"mesh wire: {rep}")
        cli = pkg.RemoteBucketStore(address=(host, port))
        stats = await cli.stats()
        await cli.aclose()
    finally:
        await server.aclose()
        await store.aclose()
    tiers = stats["store"]["tiers"]
    rows = sum(t["rows_valid"] for t in tiers.values())
    if rows < MESH_WIRE_KEYS + MESH_WIRE_SCALAR_KEYS * MESH_WIRE_ASKS:
        raise AssertionError(f"mesh wire: OP_STATS tiers count {rows} rows")
    lines.append(
        f"wire (client process): a {MESH_WIRE_KEYS}-key bulk "
        f"{MESH_WIRE_KEYS / rep['bulk_s']:.0f} rows/s; {rep['requests']} "
        f"acquire_async {rep['requests'] / rep['scalar_s']:.0f} requests/s "
        f"(client p50 {rep['p50_ms']:.2f} ms, p99 {rep['p99_ms']:.2f} ms), "
        f"{int(MESH_WIRE_CAP)} grants a key; OP_STATS tiers "
        f"{sorted(tiers)} hold {rows} rows")
    return lines


PLACE_SEED = 1919
#: Bucket keys loaded over nodes 0 and 1 at epoch 0: 1M, cut from BASELINE's
#: 10M (the path alone took over 200 s at 10M: each pull snapshots a node's
#: whole directory), then from 4M (101 s at 4M) and from 2M (53-73 s), so
#: that the whole script, the cluster path included, ends well within
#: 1,200 s.
PLACE_KEYS = 1_000_000
PLACE_CALL = 1_000_000       # keys a bulk call over the wire
PLACE_CAP = 10.0             # capacity; each key takes 1-3 tokens at load
PLACE_RATE = 1.0
PLACE_WINDOW_KEYS = 100_000  # sliding windows (limit 100 a second)
PLACE_COUNTERS = 10_000
PLACE_SEMAS = 10_000         # semaphores of limit 5, 2 permits held
PLACE_SEMA_LIMIT = 5
PLACE_DUAL_KEYS = 10_000     # moved keys driven at both owners (check 3)
PLACE_DUAL_ASKS = 16         # unit asks a key at each owner
PLACE_GAP_ASKS = 8           # unit asks a key at its old owner mid-export
PLACE_SAMPLE = 1_000         # keys checked one frame each over the wire
#: The handoff window the coordinator asks for: long enough that no
#: handoff of this path expires (expiry is the CPU tests' case).
PLACE_WINDOW_S = 900.0
PLACE_TENANT = (1000.0, 100.0)  # the reservation lane's tenant budget
PLACE_HOLD = 40.0               # its hold, settled at 25
PLACE_RES_KEY = (100.0, 10.0)   # the held key's bucket


class _PlaceCoordinator:
    """The coordinator of the placement path: JAX ``cluster.py:781-912``
    (``_apply_placement``) step for step over the port's
    ``RemoteBucketStore``s — health-gate the new owners, pull (park and
    debit) from the old ones page by page, split and push the state in
    chunks (batch ids namespaced by source), then commit by announcing the
    target epoch to the new owners first, the old owners next and the
    bystanders last, or abort before the commit by announcing the abort
    to every node involved. The path calls the steps one by one, so that
    it can check state between them; ``between`` runs after the new owners
    adopted the target and before the old owners do (the dual-ownership
    window)."""

    def __init__(self, pl, clis, pmap, window_s: float) -> None:
        self.pl, self.clis, self.pmap = pl, clis, pmap
        self.window_s = window_s
        self.pull_s = self.push_s = 0.0
        self.pages = 0
        self.rows_pushed = 0
        self.pushes = 0

    async def pull(self, target, moves, first_page_only=False) -> dict:
        """Health, then every source's pages (``first_page_only``: the
        first, whose request exports, debits and parks the source; a
        coordinator that fails there aborts): ``{src: entries}``."""
        src_of_slot = {int(s): int(self.pmap.slot_owner[s]) for s in moves}
        for j in sorted(set(moves.values())):
            await self.clis[j].ping()
        t = time.perf_counter()
        pulls = {}
        for src in sorted(set(src_of_slot.values())):
            req = {"target_epoch": target.epoch, "window_s": self.window_s,
                   "slots": sorted(s for s, o in src_of_slot.items()
                                   if o == src)}
            out = await self.clis[src].migrate_pull(req)
            entries = out["entries"]
            self.pages = int(out["pages"])
            for page in range(1, 1 if first_page_only else self.pages):
                more = await self.clis[src].migrate_pull({**req,
                                                          "page": page})
                entries = self.pl.merge_entries(entries, more["entries"])
            if self.pl.entry_count(entries):
                pulls[src] = entries
        self.pull_s = time.perf_counter() - t
        return pulls

    async def push(self, target, pulls: dict, only_first=False) -> list:
        """Split each source's export by new owner and push it in chunks;
        returns the pushes ``(dst, req)`` made."""
        t = time.perf_counter()
        made = []
        for src, entries in pulls.items():
            per_dst = self.pl.split_entries(entries, target.node_of)
            for dst, sub in sorted(per_dst.items()):
                if dst == src:
                    continue
                for bid, chunk in enumerate(self.pl.chunk_entries(sub)):
                    req = {"target_epoch": target.epoch,
                           "batch": (src << 20) | bid, "entries": chunk}
                    self.rows_pushed += await self.clis[dst].migrate_push(
                        req)
                    self.pushes += 1
                    made.append((dst, req))
                    if only_first:
                        self.push_s = time.perf_counter() - t
                        return made
        self.push_s = time.perf_counter() - t
        return made

    async def abort(self, target, moves) -> None:
        involved = ({int(self.pmap.slot_owner[s]) for s in moves}
                    | set(moves.values()))
        for j in sorted(involved):
            await self.clis[j].placement_announce(
                {"abort_epoch": target.epoch})

    async def commit(self, target, moves, between=None) -> None:
        srcs = {int(self.pmap.slot_owner[s]) for s in moves}
        dsts = set(moves.values())
        for j in sorted(dsts):
            await self.clis[j].placement_announce(
                {"map": target.to_dict(), "node_id": j})
        if between is not None:
            await between()
        rest = ([j for j in sorted(srcs) if j not in dsts]
                + [j for j in range(len(self.clis))
                   if j not in dsts and j not in srcs])
        for j in rest:
            await self.clis[j].placement_announce(
                {"map": target.to_dict(), "node_id": j})
        self.pmap = target


def _tenant_in(pmap, slots, prefix: str) -> str:
    """The first name ``<prefix><i>`` whose slot is in ``slots``."""
    i = 0
    while pmap.slot_of(f"{prefix}{i}") not in slots:
        i += 1
    return f"{prefix}{i}"


async def _frames(addr, frames: list) -> dict:
    """Pipeline ``frames`` on one connection; the replies' bodies by seq."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    reader, writer = await asyncio.open_connection(*addr)
    try:
        for f in frames:
            writer.write(f)
        await writer.drain()
        out = {}
        for _ in frames:
            body = await asyncio.wait_for(wire.read_frame(reader), 60)
            out[int.from_bytes(body[1:5], "little")] = body
        return out
    finally:
        writer.close()


async def _place_gates_pair(pkg, pl, wire, tmp: str) -> list:
    """Check 5's lanes and check 6's save: a native and an asyncio server,
    each over a card store of 2^16 slots on one frozen clock, announced the
    same epoch-1 map (node 0 of two) and parked on the same slot by one
    pull; the same frames (per-request ACQUIRE / WINDOW / SEMA / PEEK on
    owned, moved and parked keys, pipelined so the native lane batches
    them; bulk frames served, gated and moved) answer byte for byte alike.
    Then the asyncio server's ``OP_SAVE`` stamps epoch 1 and a load held to
    another epoch raises ``PlacementMismatchError``."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    clock = pkg.ManualClock(1_000_000)
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=2**16,
                                    clock=clock) for _ in range(2)]
    path = os.path.join(tmp, "pair.snap")
    servers = [pkg.BucketStoreServer(stores[0], host="127.0.0.1", port=0,
                                     native_frontend=True),
               pkg.BucketStoreServer(stores[1], host="127.0.0.1", port=0,
                                     snapshot_path=path)]
    for s in servers:
        s.placement = pl.NodePlacementState(clock=clock.now_seconds)
    addrs = [await s.start() for s in servers]
    try:
        pmap = pl.PlacementMap(1, [0, 1] * 8)
        ann = json.dumps({"map": pmap.to_dict(), "node_id": 0})
        keys = [f"g{i}" for i in range(512)]
        owned = [k for k in keys if pmap.node_of(k) == 0]
        parked_slot = pmap.slot_of(owned[0])
        parked = [k for k in owned if pmap.slot_of(k) == parked_slot]
        moved = [k for k in keys if pmap.node_of(k) == 1]
        served = [k for k in owned if pmap.slot_of(k) != parked_slot]
        for st in stores:
            await st.acquire_many(owned, [2] * len(owned), PLACE_CAP,
                                  PLACE_RATE)
            await st.window_acquire_many(owned, [3] * len(owned), 100.0,
                                         1.0)
            await st.concurrency_acquire_many(owned, [1] * len(owned), 5)
        pull = json.dumps({"target_epoch": 2, "slots": [parked_slot],
                           "window_s": PLACE_WINDOW_S})
        setup = [wire.encode_request(1, wire.OP_PLACEMENT_ANNOUNCE, ann),
                 wire.encode_request(2, wire.OP_MIGRATE_PULL, pull)]
        replies = []
        for frame in setup:
            rs = [await _frames(a, [frame]) for a in addrs]
            if rs[0] != rs[1]:
                raise AssertionError(f"placement gates: setup replies "
                                     f"differ {rs}")
            replies.append(rs[0])
        # Three groups, each sent once the one before has answered (the
        # native lane decides the batch lane, the passthrough lane and the
        # bulk lane apart, so only arrival order within a group is kept):
        # per-request admissions, each (key, op) once, pipelined so the
        # C batcher groups them; PEEKs; then bulk frames one at a time.
        rng = np.random.default_rng(PLACE_SEED + 5)
        admit = (wire.OP_ACQUIRE, wire.OP_WINDOW, wire.OP_FWINDOW,
                 wire.OP_SEMA)
        combos = [(k, op) for pool in (parked, moved, served)
                  for k in pool[:32] for op in admit]
        order = rng.permutation(len(combos))
        groups = [[], [], []]
        seq = 100
        for n in order.tolist():
            k, op = combos[n]
            count = (-1 if op == wire.OP_SEMA and rng.random() < 0.3
                     else int(rng.integers(0, 3)))
            a, b = ((5.0, 0.0) if op == wire.OP_SEMA
                    else (100.0, 1.0) if op != wire.OP_ACQUIRE
                    else (PLACE_CAP, PLACE_RATE))
            groups[0].append(wire.encode_request(seq, op, k, count, a, b))
            seq += 1
        for k in parked[:8] + moved[:8] + served[:8]:
            groups[1].append(wire.encode_request(seq, wire.OP_PEEK, k, 0,
                                                 PLACE_CAP, PLACE_RATE))
            seq += 1
        for ks in (served[:40], parked + served[:20],
                   served[:10] + moved[:1], parked * 3):
            groups[2].append(wire.encode_bulk_request(
                seq, [k.encode() for k in ks], np.ones(len(ks), np.int64),
                PLACE_CAP, PLACE_RATE))
            seq += 1
        got = [{}, {}]
        for side, a in enumerate(addrs):
            for g, frames in enumerate(groups):
                if g < 2:
                    got[side].update(await _frames(a, frames))
                else:
                    for f in frames:
                        got[side].update(await _frames(a, [f]))
        frames = groups[0] + groups[1] + groups[2]
        if got[0] != got[1]:
            diff = [q for q in got[1] if got[0].get(q) != got[1][q]]
            raise AssertionError(
                f"placement gates: native and asyncio replies differ at "
                f"seqs {diff[:10]}: "
                + "; ".join(f"{wire.decode_response(got[0][q])} != "
                            f"{wire.decode_response(got[1][q])}"
                            for q in diff[:3]))
        text = b"".join(got[0].values())
        kinds = {w: text.count(w) for w in (
            b"placement moved", b"placement handoff in progress")}
        if not all(kinds.values()):
            raise AssertionError(f"placement gates: answers {kinds}")
        envelope = servers[0].placement.envelope_decisions
        if envelope <= 0 or envelope != servers[1].placement.envelope_decisions:
            raise AssertionError("placement gates: envelope decisions "
                                 f"{servers[0].placement.envelope_decisions}"
                                 f" / {servers[1].placement.envelope_decisions}")
        # Check 6: the save stamps the adopted epoch.
        save = await _frames(addrs[1], [wire.encode_request(
            3, wire.OP_SAVE)])
        if wire.decode_response(save[3])[1] != wire.RESP_EMPTY:
            raise AssertionError(f"placement save: {save}")
        fresh = pkg.DeviceBucketStore(device="cuda", n_slots=2**16,
                                      clock=clock)
        try:
            checkpoint.load_snapshot(fresh, path,
                                     expected_placement_epoch=7)
        except checkpoint.PlacementMismatchError:
            pass
        else:
            raise AssertionError("placement save: a load held to epoch 7 "
                                 "did not raise")
        checkpoint.load_snapshot(fresh, path, expected_placement_epoch=1)
        back = fresh.peek_blocking(served[0], PLACE_CAP, PLACE_RATE)
        if back != stores[1].peek_blocking(served[0], PLACE_CAP,
                                           PLACE_RATE):
            raise AssertionError("placement save: restored balance differs")
        return [f"native and asyncio lanes byte-equal on {len(frames)} "
                f"frames ({kinds[b'placement moved']} MOVED, "
                f"{kinds[b'placement handoff in progress']} deferrals, "
                f"{envelope} envelope decisions a server); the save "
                "stamps epoch 1, a load held to epoch 7 raises "
                "PlacementMismatchError"]
    finally:
        for s in servers:
            await s.aclose()
        for st in stores:
            await st.aclose()


async def placement_path(torch, ck, pkg, card: str) -> dict:
    """Placement and live migration (phase 16): three
    ``BucketStoreServer``s, each over a card ``DeviceBucketStore`` of 2^24
    slots, on one frozen ManualClock; keys loaded at epoch 0 under
    ``PlacementMap.initial(2)`` over nodes 0 and 1 through ``acquire_many``
    over the wire; a join of node 2 migrated by :class:`_PlaceCoordinator`
    (JAX's ``_apply_placement``), the dual-ownership drive inside its
    handoff window, a drain of node 1 aborted after its pull, the
    reservation lane's gates and holds, the native lane's gates, the
    save's epoch, ``OP_STATS``, ``/metrics`` and the audit. Returns the
    path's launches."""
    import shutil
    import tempfile

    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import (
        placement as pl,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    t_path = time.perf_counter()
    rng = np.random.default_rng(PLACE_SEED)
    ck.reset_launches()
    def say(line: str) -> None:
        print(f"placement path ({card}) "
              f"[{time.perf_counter() - t_path:.1f} s]: {line}", flush=True)

    clock = pkg.ManualClock(1_000_000)
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                    counter_slots=2**15, clock=clock)
              for _ in range(3)]
    servers = [pkg.BucketStoreServer(s, host="127.0.0.1", port=0)
               for s in stores]
    for s in servers:
        # The handoff envelopes and windows on the same frozen clock: an
        # envelope refills nothing across a migration, so the balances
        # compare exactly (window expiry is the CPU tests' case).
        s.placement = pl.NodePlacementState(clock=clock.now_seconds)
    addrs = [await s.start() for s in servers]
    clis = [pkg.RemoteBucketStore(address=a, request_timeout_s=900.0)
            for a in addrs]
    solo = [pkg.RemoteBucketStore(address=a, coalesce_requests=False,
                                  request_timeout_s=60.0) for a in addrs]
    tmp = tempfile.mkdtemp(prefix="drl-place-")
    try:
        pmap0 = pl.PlacementMap.initial(2)
        for j, cli in enumerate(clis):  # the coordinator's bootstrap
            if await cli.placement_announce(
                    {"map": pmap0.to_dict(), "node_id": j}) != 0:
                raise AssertionError("placement: bootstrap epoch")
        # -- the load: every node's keys through acquire_many on the wire.
        t = time.perf_counter()
        keys = [f"pk{i}" for i in range(PLACE_KEYS)]
        owner0 = pmap0.route(keys)
        counts = rng.integers(1, 4, PLACE_KEYS)
        for j in (0, 1):
            idx = np.nonzero(owner0 == j)[0]
            for pos in range(0, len(idx), PLACE_CALL):
                part = idx[pos:pos + PLACE_CALL]
                res = await clis[j].acquire_many(
                    [keys[i] for i in part], counts[part], PLACE_CAP,
                    PLACE_RATE, with_remaining=False)
                if res.granted_count != len(part):
                    raise AssertionError("placement load: a fresh key "
                                         "was denied")
        load_s = time.perf_counter() - t
        wkeys = [f"pw{i}" for i in range(PLACE_WINDOW_KEYS)]
        wown = pmap0.route(wkeys)
        ckeys = [f"pc{i}" for i in range(PLACE_COUNTERS)]
        cown = pmap0.route(ckeys)
        cvals = rng.integers(1, 50, PLACE_COUNTERS).astype(np.float64)
        skeys = [f"ps{i}" for i in range(PLACE_SEMAS)]
        sown = pmap0.route(skeys)
        for j in (0, 1):
            wj = [k for k, o in zip(wkeys, wown) if o == j]
            res = await clis[j].window_acquire_many(
                wj, [1] * len(wj), 100.0, 1.0)
            if not res.granted.all():
                raise AssertionError("placement load: a window was denied")
            # Counters and semaphores in one launch each, in process (the
            # wire has no bulk frame for them; a frame a key would take
            # seconds of launches here).
            cj = cown == j
            await stores[j].sync_counters_many(
                [k for k, m in zip(ckeys, cj) if m], cvals[cj], DECAY_PER_S)
            sj = [k for k, o in zip(skeys, sown) if o == j]
            got = await stores[j].concurrency_acquire_many(
                sj, np.full(len(sj), 2, np.int64), PLACE_SEMA_LIMIT)
            if not np.asarray(got.granted).all():
                raise AssertionError("placement load: a semaphore refused")
        setup_s = time.perf_counter() - t - load_s
        # -- check 1: routing at epoch 0.
        sample = rng.choice(PLACE_KEYS, PLACE_SAMPLE, replace=False)
        for i in sample.tolist():
            own = int(owner0[i])
            r = await solo[own].acquire(keys[i], 0, PLACE_CAP, PLACE_RATE)
            if abs(r.remaining - (PLACE_CAP - counts[i])) > 0:
                raise AssertionError(f"placement routing: {keys[i]} reads "
                                     f"{r.remaining} on node {own}")
            try:
                await solo[1 - own].acquire(keys[i], 0, PLACE_CAP,
                                            PLACE_RATE)
            except wire.RemoteStoreError as exc:
                want = (f"placement moved: key routes to node {own} at "
                        "epoch 0")
                if want not in str(exc):
                    raise AssertionError(f"placement routing: {exc}")
            else:
                raise AssertionError(f"placement routing: {keys[i]} "
                                     f"served on node {1 - own}")
        say(f"epoch 0: {PLACE_KEYS:,} bucket keys loaded over "
                     f"nodes 0 and 1 in {load_s:.1f} s "
                     f"({PLACE_KEYS / load_s / 1e6:.2f} M rows/s), "
                     f"{PLACE_WINDOW_KEYS:,} windows, {PLACE_COUNTERS:,} "
                     f"counters, {PLACE_SEMAS:,} semaphores in "
                     f"{setup_s:.1f} s more; "
                     f"{PLACE_SAMPLE:,} keys served by their owner and "
                     "MOVED by the other")
        # -- the join of node 2 (epoch 1).
        moves = pmap0.rebalance_moves([0, 1, 2])
        target = pmap0.with_assignments(moves)
        moved_slots = set(moves)
        slot_of = np.asarray(pl.route_keys(keys, pmap0.n_slots))
        is_moved = np.isin(slot_of, np.fromiter(moved_slots, np.int64))
        moved_idx = np.nonzero(is_moved)[0]
        kept_idx = np.nonzero(~is_moved)[0]
        tenant = _tenant_in(pmap0, {s for s, d in moves.items()
                                    if pmap0.slot_owner[s] == 0}, "pt")
        hold = await clis[0].reserve("hold-1", tenant, "pk-res", PLACE_HOLD,
                                     *PLACE_TENANT, *PLACE_RES_KEY,
                                     ttl_s=3600.0)
        if not hold.granted:
            raise AssertionError(f"placement reserve: {hold}")
        timers = [_HoldTimer(s._lock) for s in stores[:2]]
        export_s = [0.0]
        for s, timer in zip(stores[:2], timers):
            s._lock = timer
            _time_calls(s, "export_entries", export_s)
        coord = _PlaceCoordinator(pl, clis, pmap0, PLACE_WINDOW_S)
        launch_before = dict(ck.launches)
        debit_ms = [0.0, 0]
        real_debit = ck.debit_packed

        def timed_debit(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_debit(*args, **kwargs)
            end.record()
            end.synchronize()
            debit_ms[0] += start.elapsed_time(end)
            debit_ms[1] += 1
            return out

        # -- check 3, first half: while each source exports (its slots
        # parked, the pull not yet answered), unit asks on its dual keys
        # at that source; they serve from the handoff envelope.
        dual_idx = rng.choice(moved_idx, PLACE_DUAL_KEYS, replace=False)
        dual = [keys[i] for i in dual_idx]
        admitted = np.zeros((3, PLACE_DUAL_KEYS), np.int64)
        pull_task = asyncio.ensure_future(coord.pull(target, moves))
        gap = []
        for src in (0, 1):
            ps = servers[src].placement
            t = time.perf_counter()
            while not ps._parked_slots:
                if pull_task.done():
                    await pull_task
                    raise AssertionError(f"placement gap: node {src} never "
                                         "parked during the pull")
                await asyncio.sleep(0.005)
            rows = np.repeat(np.nonzero(owner0[dual_idx] == src)[0],
                             PLACE_GAP_ASKS)
            t_ask = time.perf_counter()
            for pos in range(0, len(rows), BATCH):
                part = rows[pos:pos + BATCH]
                out = await solo[src].acquire_many(
                    [dual[r] for r in part], np.ones(len(part), np.int64),
                    PLACE_CAP, PLACE_RATE, with_remaining=False)
                np.add.at(admitted[0], part,
                          np.asarray(out.granted, np.int64))
            if ps.pulls or not ps._parked_slots:
                raise AssertionError(f"placement gap: node {src}'s export "
                                     "ended before its asks did")
            gap.append(f"node {src}: {len(rows):,} asks "
                       f"{time.perf_counter() - t_ask:.2f} s after it parked "
                       f"({t_ask - t:.2f} s into its pull)")
        pulls = await pull_task
        hold_s = max(t.longest for t in timers)
        pull_s, pull_export_s = coord.pull_s, export_s[0]
        pulled = sum(pl.entry_count(e) for e in pulls.values())
        if not any(e.get("reservations") for e in pulls.values()):
            raise AssertionError("placement pull: the hold did not ship")
        ck.debit_packed = timed_debit
        try:
            await coord.push(target, pulls)
        finally:
            ck.debit_packed = real_debit
        push_launches = {k: v - launch_before.get(k, 0)
                         for k, v in ck.launches.items()
                         if v > launch_before.get(k, 0)}
        say(
            f"join of node 2 ({card}): {len(moves)} of {pmap0.n_slots} "
            f"slots, {len(moved_idx):,} bucket keys; pull {pull_s:.1f} s "
            f"for {pulled:,} rows ({pull_export_s:.1f} s of it the "
            "sources' export_entries: the snapshot and the per-key "
            "filter), the store lock's longest hold "
            f"{hold_s:.2f} s; push {coord.push_s:.1f} s, {coord.pushes} "
            f"pushes, {coord.rows_pushed:,} rows "
            f"({coord.rows_pushed / coord.push_s:,.0f} rows/s); the "
            f"import's debit_packed launches {debit_ms[1]}, "
            f"{debit_ms[0]:.2f} ms of CUDA events around them; launches "
            f"of pull and push {json.dumps(push_launches)}")

        # -- check 3 (inside the handoff window: node 2 adopted epoch 1,
        # the sources still park): acquires at both owners.
        asks = np.repeat(np.arange(PLACE_DUAL_KEYS), PLACE_DUAL_ASKS)
        checks = []

        async def between():
            for side, j in enumerate((None, 2), start=1):
                for pos in range(0, len(asks), BATCH):
                    rows = asks[pos:pos + BATCH]
                    kj = [dual[r] for r in rows]
                    if j is None:  # each key at its old owner
                        res = [None] * len(rows)
                        for src in (0, 1):
                            sel = [n for n, r in enumerate(rows)
                                   if owner0[dual_idx[r]] == src]
                            if not sel:
                                continue
                            out = await clis[src].acquire_many(
                                [kj[n] for n in sel],
                                np.ones(len(sel), np.int64),
                                PLACE_CAP, PLACE_RATE,
                                with_remaining=False)
                            for n, g in zip(sel, out.granted):
                                res[n] = g
                        granted = np.asarray(res, bool)
                    else:
                        granted = (await clis[2].acquire_many(
                            kj, np.ones(len(rows), np.int64), PLACE_CAP,
                            PLACE_RATE,
                            with_remaining=False)).granted
                    np.add.at(admitted[side], rows, granted.astype(np.int64))
            # The reservation lane mid-handoff: a settle defers, a reserve
            # serves from the envelope.
            r = await _raw_request(addrs[0], wire.encode_request(
                11, wire.OP_SETTLE, json.dumps(
                    {"rid": "hold-1", "tenant": tenant, "actual": 25.0})))
            checks.append(("settle mid-handoff", r))
            r = await _raw_request(addrs[0], wire.encode_request(
                12, wire.OP_RESERVE, json.dumps(
                    {"rid": "hold-2", "tenant": tenant, "key": "pk-res",
                     "estimate": 3.0, "a": PLACE_RES_KEY[0],
                     "b": PLACE_RES_KEY[1],
                     "ta": PLACE_TENANT[0], "tb": PLACE_TENANT[1]})))
            checks.append(("reserve mid-handoff", r))

        await coord.commit(target, moves, between)
        pre = (PLACE_CAP - counts[dual_idx]).astype(np.float64)
        budget = headroom_budget(PLACE_CAP, fraction=0.5, min_budget=1.0)
        over = admitted.sum(axis=0) - (pre + budget)
        if (over > 0).any():
            raise AssertionError(f"dual ownership: {int((over > 0).sum())} "
                                 "keys over balance + one envelope")
        if admitted[0].sum() == 0 or admitted[2].sum() == 0:
            raise AssertionError(f"dual ownership: admitted {admitted.sum(1)}")
        (_, kind, vals) = checks[0][1]
        if kind != wire.RESP_ERROR or pl.HANDOFF_DEFERRAL_PREFIX not in vals[0]:
            raise AssertionError(f"settle mid-handoff: {checks[0]}")
        (_, kind, vals) = checks[1][1]
        if kind != wire.RESP_TEXT or not json.loads(vals[0]).get("envelope"):
            raise AssertionError(f"reserve mid-handoff: {checks[1]}")
        say(
            f"dual ownership ({card}): {PLACE_DUAL_KEYS:,} moved keys x "
            f"{PLACE_GAP_ASKS} asks at the old owner during its export "
            f"({'; '.join(gap)}), then {PLACE_DUAL_ASKS} asks at each "
            f"owner: admitted old {int(admitted[0].sum()):,} during the "
            f"export + {int(admitted[1].sum()):,} after it (envelope), new "
            f"{int(admitted[2].sum()):,}; max over (balance + envelope "
            f"{budget:.0f}) {int(over.max())} (<= 0 holds); mid-handoff "
            "settle deferred, reserve served from the envelope")

        # -- check 2: state after the commit.
        src_tok = np.float32(PLACE_CAP) - counts.astype(np.float32)
        shipped = np.maximum(np.float32(0.0), src_tok - np.float32(budget))
        not_dual = np.setdiff1d(moved_idx, dual_idx)
        res = await stores[2].acquire_many(
            [keys[i] for i in not_dual], np.zeros(len(not_dual), np.int64),
            PLACE_CAP, PLACE_RATE)
        bad = np.nonzero(res.remaining != shipped[not_dual])[0]
        if len(bad):
            i = int(not_dual[bad[0]])
            raise AssertionError(
                f"placement import: {len(bad)} keys differ from the host "
                f"oracle ({keys[i]}: {res.remaining[bad[0]]} != "
                f"{shipped[i]})")
        for j in (0, 1):
            mine = not_dual[owner0[not_dual] == j]
            res = await stores[j].acquire_many(
                [keys[i] for i in mine], np.zeros(len(mine), np.int64),
                PLACE_CAP, PLACE_RATE)
            if not (res.remaining == np.float32(budget)).all():
                raise AssertionError(f"placement source {j}: residual is "
                                     "not the envelope")
            kept = kept_idx[owner0[kept_idx] == j]
            res = await stores[j].acquire_many(
                [keys[i] for i in kept], np.zeros(len(kept), np.int64),
                PLACE_CAP, PLACE_RATE)
            if not (res.remaining == src_tok[kept]).all():
                raise AssertionError(f"placement node {j}: an unmoved "
                                     "key's balance changed")
        moved_sample = rng.choice(not_dual, PLACE_SAMPLE, replace=False)
        for i in moved_sample.tolist():
            try:
                await solo[int(owner0[i])].acquire(keys[i], 0, PLACE_CAP,
                                                   PLACE_RATE)
            except wire.RemoteStoreError as exc:
                if "key routes to node 2 at epoch 1" not in str(exc):
                    raise AssertionError(f"placement commit: {exc}")
            else:
                raise AssertionError(f"placement commit: {keys[i]} served "
                                     "by its old owner")
            peek = await asyncio.to_thread(solo[2].peek_blocking, keys[i],
                                           PLACE_CAP, PLACE_RATE)
            if peek != shipped[i]:
                raise AssertionError(f"placement peek: {keys[i]} {peek} "
                                     f"!= {shipped[i]}")
        # Windows, counters and semaphores by the generic lane's rules.
        wmoved = [k for k in wkeys if pmap0.slot_of(k) in moved_slots]
        wbudget = headroom_budget(100.0, fraction=0.5, min_budget=1.0)
        res = await stores[2].window_acquire_many(
            wmoved, np.zeros(len(wmoved), np.int64), 100.0, 1.0)
        if not (res.remaining == np.float32(100.0 - (1 + wbudget))).all():
            raise AssertionError("placement windows: the new owner's count "
                                 "is not the replayed one")
        for j in (0, 1):
            wsrc = [k for k in wmoved if pmap0.node_of(k) == j]
            res = await stores[j].window_acquire_many(
                wsrc, np.zeros(len(wsrc), np.int64), 100.0, 1.0)
            if not (res.remaining == 0.0).all():
                raise AssertionError("placement windows: a source window "
                                     "was not charged to its limit")
        cmask = np.isin(np.asarray(pl.route_keys(ckeys, pmap0.n_slots)),
                        np.fromiter(moved_slots, np.int64))
        cm = [k for k, m in zip(ckeys, cmask) if m]
        got = await stores[2].sync_counters_many(
            cm, np.zeros(len(cm)), DECAY_PER_S)
        score = np.asarray(got[0] if isinstance(got, tuple) else
                           [r.global_score for r in got])
        if not np.array_equal(score.astype(np.float32),
                              cvals[cmask].astype(np.float32)):
            raise AssertionError("placement counters: a value differs")
        sm = [k for k in skeys if pmap0.slot_of(k) in moved_slots]
        res = await stores[2].concurrency_acquire_many(
            sm, np.zeros(len(sm), np.int64), PLACE_SEMA_LIMIT)
        # A probe's remaining reads the permits held.
        if not (np.asarray(res.remaining) == 2).all():
            raise AssertionError("placement semaphores: held permits differ")
        # The reservation lane after the commit.
        r = await _raw_request(addrs[0], wire.encode_request(
            13, wire.OP_SETTLE, json.dumps(
                {"rid": "hold-1", "tenant": tenant, "actual": 25.0})))
        if "key routes to node 2" not in str(r[2]):
            raise AssertionError(f"settle on the old owner: {r}")
        settled = await clis[2].settle("hold-1", tenant, 25.0)
        if settled.outcome != "settled":
            raise AssertionError(f"settle on the new owner: {settled}")
        say(
            f"epoch 1 ({card}): {len(not_dual):,} moved keys on node 2 "
            "equal the host float32 oracle of debit_export, their old "
            f"owners hold the envelope ({budget:.0f}) and answer MOVED to "
            f"node 2 ({PLACE_SAMPLE:,} over the wire, peeks equal), "
            f"{len(kept_idx):,} unmoved balances unchanged; "
            f"{len(wmoved):,} windows, {len(cm):,} counters, {len(sm):,} "
            "semaphores by the generic lane's rules; the hold settled on "
            "node 2, MOVED on node 0")

        # -- check 4: drain node 1, aborted after its pull.
        epoch_before = target.epoch
        moves2 = target.rebalance_moves([0, 2])
        target2 = target.with_assignments(moves2)
        for tm in timers:
            tm.longest = 0.0
        pulls2 = await coord.pull(target2, moves2, first_page_only=True)
        hold2 = max(t.longest for t in timers)
        made = await coord.push(target2, pulls2, only_first=True)
        dst, req = made[0]
        await coord.abort(target2, moves2)
        again = await clis[dst].migrate_push(req)
        if again <= 0 or servers[dst].placement.pushes_duplicate:
            raise AssertionError(f"abort: a retried push was deduplicated "
                                 f"({again})")
        for j, cli in enumerate(clis):
            if (await cli.placement_fetch())["epoch"] != epoch_before:
                raise AssertionError("abort: the epoch moved")
        d1 = [i for i in kept_idx[owner0[kept_idx] == 1][:PLACE_SAMPLE]]
        res = await clis[1].acquire_many(
            [keys[i] for i in d1], np.zeros(len(d1), np.int64), PLACE_CAP,
            PLACE_RATE)
        if not (res.remaining == np.float32(budget)).all():
            raise AssertionError("abort: node 1 does not serve its residual")
        say(
            f"abort ({card}): drain of node 1, its pull's first page "
            f"{coord.pull_s:.1f} s (of {coord.pages} pages; lock "
            f"{hold2:.2f} s), one push, abort: epoch {epoch_before} "
            "kept, node 1 serves its residual, the retried push applied "
            f"{again} rows again")

        # -- check 6: OP_STATS, /metrics, the audit.
        stats = await clis[0].stats()
        text = await clis[0].metrics()
        if "placement" not in stats or "drl_placement_epoch 1" not in text:
            raise AssertionError("placement: OP_STATS / metrics lack the "
                                 "placement section")
        for s in servers:
            s.auditor.tick()
        eps = [s.auditor.epsilon_used["envelope"] for s in servers]
        breaches = [s.auditor.breaches for s in servers]
        if max(eps) <= 0 or any(breaches):
            raise AssertionError(f"placement audit: envelope eps {eps}, "
                                 f"breaches {breaches}")
        say(f"OP_STATS placement {json.dumps(stats['placement'])}"
                     f"; audit clean, envelope eps {eps}")
        for line in await _place_gates_pair(pkg, pl, wire, tmp):
            say(line)
    finally:
        for c in clis + solo:
            await c.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    counts_out = dict(ck.launches)
    print(f"placement path ({card}): {time.perf_counter() - t_path:.1f} s "
          "of wall")
    torch.cuda.empty_cache()
    return counts_out


# -- phase 17: live config ----------------------------------------------------

CFG_SEED = 2020
#: Bucket keys at the retired config: 1M, cut from BASELINE's 10M. A
#: commit enumerates the whole store, as a pull does: at 2M keys (the
#: placement path's cut) the path took 115-116 s and the whole script
#: 1,130 s, past the 1,100 s this script keeps under its 1,200 s limit.
CFG_KEYS = 1_000_000
CFG_CALL = 1_000_000          # keys a bulk call over the wire
CFG_OLD = (10.0, 1.0)         # the bucket config version 1 retires
CFG_NEW = (6.0, 1.0)          # its replacement: capacity cut
CFG_WINDOW_KEYS = 100_000     # sliding windows, and as many fixed ones
CFG_WINDOW = (50.0, 60.0)     # limit, seconds (both kinds)
CFG_WINDOW_NEW = (30.0, 60.0)  # version 2 (sliding)
CFG_FWINDOW_NEW = (20.0, 60.0)  # version 3 (fixed); version 4 reverts it
CFG_CONC_KEYS = 10_000        # asked at the old config while v1 commits
CFG_PEEKS = 2_000             # 10,000 (20 s) until the drain path joined
CFG_FRESH = 4                 # fresh clients on the old config
CFG_TENANT = (1e6, 1e-9)      # the hold's tenant budget (never retired)
CFG_HOLD = 4.0                # the hold on keys[0], settled at 1
CFG_T0 = ((1000.0, 1e-9), (500.0, 1e-9))  # tier-0's retired config


async def _cfg_native_part(pkg, lc, wire, say) -> int:
    """Check 8: a native server with tier-0 on over a card store of its own
    (JAX ``tests/test_upgrade.py:858-910``'s shape) beside an asyncio server
    over another; the same mutation on both. Tier-0 retires the replica
    within a sync interval, the new table accounts for every grant, and the
    batch-lane and bulk-lane moved answers equal the asyncio server's byte
    for byte. Returns the pump's retired rows."""
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        Tier0Config,
    )

    (old, new) = CFG_T0
    clock = pkg.ManualClock(1_000_000)
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=2**16,
                                    clock=clock) for _ in range(2)]
    servers = [pkg.BucketStoreServer(
        stores[0], host="127.0.0.1", port=0, native_frontend=True,
        native_tier0=Tier0Config(min_budget=8.0, sync_interval_s=0.02,
                                 max_stale_s=10.0)),
        pkg.BucketStoreServer(stores[1], host="127.0.0.1", port=0)]
    addrs = [await s.start() for s in servers]
    c = pkg.RemoteBucketStore(address=addrs[0], coalesce_requests=False,
                              request_timeout_s=60.0)
    try:
        for _ in range(200):
            if not (await c.acquire("hot", 1, *old)).granted:
                raise AssertionError("config tier-0: a hot ask denied")
        m = servers[0]._native.t0_metrics
        deadline = time.monotonic() + 30.0
        while m.syncs < 1:  # a replica installed, its grants synced
            if time.monotonic() > deadline:
                raise AssertionError("config tier-0: no replica synced")
            await asyncio.sleep(0.01)
        t = time.perf_counter()
        for n, payload in enumerate((
                {"prepare": {"kind": "bucket", "old": list(old),
                             "new": list(new)}, "version": 1},
                {"commit": 1})):
            frame = wire.encode_request(50 + n, wire.OP_CONFIG,
                                        json.dumps(payload))
            rs = [await _frames(a, [frame]) for a in addrs]
            if rs[0] != rs[1]:
                raise AssertionError(f"config tier-0: {rs}")
        # Right after the commit stale frames may still be served from the
        # replica's last-acked headroom (the one-sync-interval epsilon).
        for _ in range(100):
            if not (await c.acquire("hot", 1, *old)).granted:
                raise AssertionError("config tier-0: a stale ask denied")
        while m.retired_config_rows < 1:
            if time.perf_counter() - t > 30.0:
                raise AssertionError("config tier-0: the pump never retired "
                                     "the old replica")
            await asyncio.sleep(0.005)
        retire_s = time.perf_counter() - t
        if not (await c.acquire("hot", 1, *old)).granted:
            raise AssertionError("config tier-0: the chased ask denied")
        # Every grant (301) on the new table, once the pump has synced.
        deadline = time.monotonic() + 30.0
        while stores[0].peek_blocking("hot", *new) > new[0] - 301 + 16:
            if time.monotonic() > deadline:
                raise AssertionError(
                    "config tier-0: the new table holds "
                    f"{stores[0].peek_blocking('hot', *new)}")
            await asyncio.sleep(0.01)
        bal = stores[0].peek_blocking("hot", *new)
        if abs(bal - (new[0] - 301)) > 16:
            raise AssertionError(f"config tier-0: balance {bal}")
        frames = [wire.encode_request(60, wire.OP_ACQUIRE, "hot", 1, *old),
                  wire.encode_bulk_request(61, [b"hot", b"cold"],
                                           np.ones(2, np.int64), *old)]
        got = [{}, {}]
        for side, a in enumerate(addrs):
            for f in frames:  # one at a time: the two native lanes apart
                got[side].update(await _frames(a, [f]))
        want = lc.moved_message("bucket", old, new, 1)
        for seq in (60, 61):
            if got[0][seq] != got[1][seq]:
                raise AssertionError(
                    f"config tier-0: native {wire.decode_response(got[0][seq])}"
                    f" != asyncio {wire.decode_response(got[1][seq])}")
            _, kind, vals = wire.decode_response(got[0][seq])
            if kind != wire.RESP_ERROR or vals[0] != want:
                raise AssertionError(f"config tier-0: {vals}")
        say(f"tier-0 ({CFG_T0[0]} -> {CFG_T0[1]}): the pump retired the "
            f"replica within {retire_s * 1e3:.0f} ms of the commit and 100 "
            f"stale asks (retired_config_rows {m.retired_config_rows}), the "
            "new table "
            f"{bal:.0f} = {new[0]:.0f} - 301 grants (within 16); the batch "
            "lane's and the bulk lane's moved answers equal the asyncio "
            "server's byte for byte")
        return int(m.retired_config_rows)
    finally:
        await c.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()


async def config_path(torch, ck, pkg, card: str) -> dict:
    """Live config (phase 17): one ``BucketStoreServer`` over a card
    ``DeviceBucketStore`` of 2^24 slots on a frozen ManualClock, 1M bucket
    keys at one config with seeded spends, 100,000 sliding and 100,000 fixed
    windows with seeded counts, loaded over the wire; four committed
    mutations through ``OP_CONFIG`` (bucket capacity cut, a sliding and a
    fixed window cut, the fixed one reverted), each rebase held to a host
    float32 oracle, asks at the old config while the first commits, fresh
    clients' one chase, the moved text, a stale prepare, a hold settled
    across the commit, tier-0's retire on a native server, ``OP_STATS``,
    ``/metrics`` and the audit. Returns the path's launches."""
    from distributedratelimiting.redis_tpu_torch.runtime import (
        liveconfig as lc,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    t_path = time.perf_counter()
    rng = np.random.default_rng(CFG_SEED)
    ck.reset_launches()

    def say(line: str) -> None:
        print(f"config path ({card}) "
              f"[{time.perf_counter() - t_path:.1f} s]: {line}", flush=True)

    def rule(kind, old, new) -> dict:
        return {"kind": kind, "old": list(old), "new": list(new)}

    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  clock=clock)
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0)
    addr = await server.start()
    cli = pkg.RemoteBucketStore(address=addr, request_timeout_s=900.0)
    solo = pkg.RemoteBucketStore(address=addr, coalesce_requests=False,
                                 request_timeout_s=900.0)
    extra = []
    real_debit = ck.debit_packed
    try:
        # -- check 1: a fresh node's fetch.
        got = await cli.config_fetch()
        if got != {"version": 0, "rules": []}:
            raise AssertionError(f"config fetch: {got}")
        # -- the load: every key through acquire_many over the wire.
        keys = [f"ck{i}" for i in range(CFG_KEYS)]
        spend = rng.integers(0, int(CFG_OLD[0]) + 1, CFG_KEYS)
        spend[0] = 0  # keys[0] carries the hold (check 7)
        t = time.perf_counter()
        for pos in range(0, CFG_KEYS, CFG_CALL):
            res = await cli.acquire_many(
                keys[pos:pos + CFG_CALL], spend[pos:pos + CFG_CALL],
                *CFG_OLD, with_remaining=False)
            if res.granted_count != min(CFG_CALL, CFG_KEYS - pos):
                raise AssertionError("config load: a fresh key was denied")
        load_s = time.perf_counter() - t
        wkeys = [f"cw{i}" for i in range(CFG_WINDOW_KEYS)]
        wcount = rng.integers(1, int(CFG_WINDOW[0]) + 1, CFG_WINDOW_KEYS)
        fcount = rng.integers(1, int(CFG_WINDOW[0]) + 1, CFG_WINDOW_KEYS)
        for counts, fixed in ((wcount, False), (fcount, True)):
            res = await cli.window_acquire_many(wkeys, counts, *CFG_WINDOW,
                                                fixed=fixed,
                                                with_remaining=False)
            if res.granted_count != CFG_WINDOW_KEYS:
                raise AssertionError("config load: a window was denied")
        hold = await solo.reserve("cfg-hold", "ct", keys[0], CFG_HOLD,
                                  *CFG_TENANT, *CFG_OLD, ttl_s=3600.0)
        if not hold.granted:
            raise AssertionError(f"config hold: {hold}")
        say(f"{CFG_KEYS:,} bucket keys at {CFG_OLD} loaded over the wire in "
            f"{load_s:.1f} s ({CFG_KEYS / load_s / 1e6:.2f} M rows/s), "
            f"{CFG_WINDOW_KEYS:,} sliding and {CFG_WINDOW_KEYS:,} fixed "
            f"windows at {CFG_WINDOW}; fetch {got}; a hold of {CFG_HOLD} on "
            "keys[0]")

        # -- checks 2 and 5: version 1 commits while a client asks at the
        # old config.
        conc = np.sort(rng.choice(np.arange(1, CFG_KEYS), CFG_CONC_KEYS,
                                  replace=False))
        conc_keys = [keys[i] for i in conc]
        before = (CFG_OLD[0] - spend[conc]).astype(np.int64)
        admitted = np.zeros(CFG_CONC_KEYS, np.int64)
        asker = pkg.RemoteBucketStore(address=addr, coalesce_requests=False,
                                      request_timeout_s=900.0)
        extra.append(asker)
        ones = np.ones(CFG_CONC_KEYS, np.int64)
        lat = []

        async def ask_round():
            t = time.perf_counter()
            res = await asker.acquire_many(conc_keys, ones, *CFG_OLD,
                                           with_remaining=False)
            lat.append(time.perf_counter() - t)
            got = np.asarray(res.granted, np.int64)
            admitted[:] += got
            return int(got.sum())

        await ask_round()  # one round on the old table before the commit
        pre_rounds = len(lat)
        if await solo.config_announce({"prepare": rule("bucket", CFG_OLD,
                                                       CFG_NEW),
                                       "version": 1}) != 0:
            raise AssertionError("config prepare: the version moved")
        timer = store._lock = _HoldTimer(store._lock)
        launch_before = dict(ck.launches)
        debit_ms = [0.0, 0]

        def timed_debit(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_debit(*args, **kwargs)
            end.record()
            end.synchronize()
            debit_ms[0] += start.elapsed_time(end)
            debit_ms[1] += 1
            return out

        done = asyncio.Event()

        async def asks():
            while True:
                granted = await ask_round()
                if done.is_set() and granted == 0:
                    return

        ck.debit_packed = timed_debit
        task = asyncio.ensure_future(asks())
        try:
            t = time.perf_counter()
            version = await solo.config_announce({"commit": 1})
            commit_s = time.perf_counter() - t
            during = lat[pre_rounds:]
            done.set()
            await task
        finally:
            ck.debit_packed = real_debit
        if version != 1:
            raise AssertionError(f"config commit: version {version}")
        commit_launches = {k: v - launch_before.get(k, 0)
                           for k, v in ck.launches.items()
                           if v > launch_before.get(k, 0)}
        hold_s = timer.longest
        rebased = server.liveconfig.rebased_rows
        if rebased != CFG_KEYS:
            raise AssertionError(f"config commit: rebased_rows {rebased}")
        if debit_ms[1] <= 0:
            raise AssertionError("config commit: no debit_packed launch")
        over = admitted - before
        if (over > 1).any():
            raise AssertionError(
                f"config commit: {int((over > 1).sum())} keys admitted more "
                "than their balance plus the one round in flight")
        say(f"version 1 {CFG_OLD} -> {CFG_NEW}: commit {commit_s:.2f} s, "
            f"the store lock's longest hold {hold_s:.2f} s, rebased_rows "
            f"{rebased:,}; the rebase's debit_packed launches "
            f"{debit_ms[1]}, {debit_ms[0]:.3f} ms of CUDA events; launches "
            f"during the commit {json.dumps(commit_launches)}")
        say(f"asks at the old config on {CFG_CONC_KEYS:,} keys, one round "
            f"of one unit a key at a time: {len(lat)} rounds "
            f"({len(during)} while the commit ran, the longest "
            f"{max(during, default=0.0):.2f} s: the serving stall), admitted "
            f"{int(admitted.sum()):,} against pre-commit balances "
            f"{int(before.sum()):,}; over-admission (admitted - balance) "
            f"max {int(over.max())}, {int((over > 0).sum())} keys over by "
            f"1, {int(over[over > 0].sum())} tokens in all (JAX's envelope: "
            "the requests in flight when the gate flipped, one a key)")

        # -- check 3: every bucket against the host float32 oracle.
        t = time.perf_counter()
        entries = await asyncio.to_thread(store.export_entries,
                                          lambda _k: True)
        export_s = time.perf_counter() - t
        pos_of = {k: i for i, k in enumerate(keys)}
        tok_old = np.float32(CFG_OLD[0]) - spend.astype(np.float32)
        spent = (np.float32(CFG_OLD[0]) - tok_old).astype(np.float32)
        oracle = np.maximum(np.float32(0.0),
                            np.float32(CFG_NEW[0]) - spent)
        skip = np.zeros(CFG_KEYS, bool)
        skip[conc] = True
        skip[0] = True
        seen = np.zeros(CFG_KEYS, bool)
        bad = 0
        for key, cap, rate, tokens, _age in entries["buckets"]:
            if (cap, rate) != CFG_NEW:
                continue
            i = pos_of.get(key)
            if i is None or skip[i]:
                continue
            seen[i] = True
            if np.float32(tokens) != oracle[i]:
                bad += 1
        plain = ~skip
        # A key that spent nothing was never debited: it is born full.
        missing = plain & (spend > 0) & ~seen
        extra_rows = plain & (spend == 0) & seen
        if bad or missing.any() or extra_rows.any():
            raise AssertionError(
                f"config rebase: {bad} balances off the oracle, "
                f"{int(missing.sum())} spent keys missing, "
                f"{int(extra_rows.sum())} unspent keys debited")
        sample = rng.choice(np.nonzero(plain)[0], CFG_PEEKS, replace=False)
        peeker = pkg.RemoteBucketStore(address=addr, coalesce_requests=False,
                                       request_timeout_s=900.0)
        extra.append(peeker)
        t = time.perf_counter()
        peeks = await asyncio.to_thread(
            lambda: [peeker.peek_blocking(keys[i], *CFG_OLD)
                     for i in sample.tolist()])
        peek_s = time.perf_counter() - t
        if not np.array_equal(np.asarray(peeks, np.float32), oracle[sample]):
            raise AssertionError("config peek: a balance differs from the "
                                 "oracle")
        say(f"{int(plain.sum()):,} buckets on {CFG_NEW} equal the host "
            "float32 oracle max(0, new_cap - spent) through the export "
            f"({export_s:.1f} s; {int((plain & (spend == 0)).sum()):,} "
            f"unspent keys born full on first touch), {CFG_PEEKS:,} PEEKs at "
            f"the old config over the wire equal it ({peek_s:.1f} s, one "
            "chase)")

        # -- check 7: the hold settles on the new table.
        settled = await solo.settle("cfg-hold", "ct", 1.0)
        if settled.outcome != "settled" or settled.refunded != CFG_HOLD - 1:
            raise AssertionError(f"config settle: {settled}")
        bal = store.peek_blocking(keys[0], *CFG_NEW)
        want = CFG_NEW[0] - CFG_HOLD + (CFG_HOLD - 1.0)
        if bal != want or server.reservations.rehomed < 1:
            raise AssertionError(f"config settle: balance {bal} != {want}, "
                                 f"rehomed {server.reservations.rehomed}")
        say(f"the hold reserved before the commit settled after it: refund "
            f"{settled.refunded} into {CFG_NEW} (balance {bal}), rehomed "
            f"{server.reservations.rehomed}")

        # -- check 4: the window rules (versions 2 and 3).
        for v, kind, new, counts, fixed in (
                (2, "window", CFG_WINDOW_NEW, wcount, False),
                (3, "fwindow", CFG_FWINDOW_NEW, fcount, True)):
            await solo.config_announce({"prepare": rule(kind, CFG_WINDOW,
                                                        new),
                                        "version": v})
            timer.longest = 0.0
            rows_before = server.liveconfig.rebased_rows
            launch_before = dict(ck.launches)
            t = time.perf_counter()
            await solo.config_announce({"commit": v})
            commit_s = time.perf_counter() - t
            flushes = {k: ck.launches[k] - launch_before.get(k, 0)
                       for k in ("window_packed", "window_grouped")}
            if sum(flushes.values()) <= 0:
                raise AssertionError(f"config v{v}: no window flush")
            rows = server.liveconfig.rebased_rows - rows_before
            if rows != CFG_WINDOW_KEYS:
                raise AssertionError(f"config v{v}: rebased_rows {rows}")
            res = await store.window_acquire_many(
                wkeys, np.zeros(CFG_WINDOW_KEYS, np.int64), *new,
                fixed=fixed)
            want = (np.float32(new[0])
                    - np.minimum(counts, new[0]).astype(np.float32))
            if not np.array_equal(np.asarray(res.remaining, np.float32),
                                  want):
                raise AssertionError(f"config v{v}: a window differs from "
                                     "the oracle")
            say(f"version {v} ({kind} {CFG_WINDOW} -> {new}): commit "
                f"{commit_s:.2f} s, lock {timer.longest:.2f} s, "
                f"{rows:,} windows replayed in {json.dumps(flushes)} "
                "flushes, every window at floor(min(count, new limit)) "
                "(the oracle)")

        # -- check 6: fresh clients, the moved text, the revert, a stale
        # prepare.
        moved_before = server.liveconfig.moved_errors
        for n in range(CFG_FRESH):
            fresh = pkg.RemoteBucketStore(address=addr,
                                          coalesce_requests=False)
            extra.append(fresh)
            i = int(sample[n])
            r = await fresh.acquire(keys[i], 0, *CFG_OLD)
            if r.remaining != oracle[i]:
                raise AssertionError(f"config fresh client: {r}")
            res = await fresh.acquire_many(
                [keys[int(j)] for j in sample[:100]], np.zeros(100, np.int64),
                *CFG_OLD)
            if not np.array_equal(np.asarray(res.remaining, np.float32),
                                  oracle[sample[:100]]):
                raise AssertionError("config fresh client: bulk differs")
        chased = server.liveconfig.moved_errors - moved_before
        if chased != CFG_FRESH:
            raise AssertionError(f"config fresh clients: {chased} moved "
                                 f"errors for {CFG_FRESH} clients")
        replies = await _frames(addr, [
            wire.encode_request(70, wire.OP_ACQUIRE, keys[1], 1, *CFG_OLD),
            wire.encode_bulk_request(71, [keys[1].encode()],
                                     np.ones(1, np.int64), *CFG_OLD)])
        want = lc.moved_message("bucket", CFG_OLD, CFG_NEW, 1)
        for seq, body in replies.items():
            _, kind, vals = wire.decode_response(body)
            if kind != wire.RESP_ERROR or vals[0] != want:
                raise AssertionError(f"config moved text: {vals!r} != "
                                     f"{want!r}")
        await solo.config_announce({"prepare": rule(
            "fwindow", CFG_FWINDOW_NEW, CFG_WINDOW), "version": 4})
        await solo.config_announce({"commit": 4})
        fetched = await solo.config_fetch()
        fwd = {(r["kind"], *r["old"]): (*r["new"], r["version"])
               for r in fetched["rules"]}
        if (fetched["version"] != 4
                or ("fwindow", *CFG_WINDOW) in fwd
                or fwd.get(("fwindow", *CFG_FWINDOW_NEW))
                != (*CFG_WINDOW, 4)):
            raise AssertionError(f"config revert: rules {fetched}")
        # The revert replays each fixed window's carried count onto the
        # original table, which still holds its own: granted where the sum
        # stays within the limit, else nothing recorded (JAX's rule).
        res = await store.window_acquire_many(
            wkeys, np.zeros(CFG_WINDOW_KEYS, np.int64), *CFG_WINDOW,
            fixed=True)
        carried = np.minimum(fcount, CFG_FWINDOW_NEW[0])
        total = np.where(fcount + carried <= CFG_WINDOW[0],
                         fcount + carried, fcount)
        if not np.array_equal(np.asarray(res.remaining, np.float32),
                              (CFG_WINDOW[0] - total).astype(np.float32)):
            raise AssertionError("config revert: a fixed window differs")
        try:
            await solo.config_announce({"prepare": rule(
                "bucket", CFG_OLD, CFG_NEW), "version": 1})
        except wire.RemoteStoreError as exc:
            stale = str(exc)
            if "StaleConfigError" not in stale:
                raise AssertionError(f"config stale prepare: {exc}")
        else:
            raise AssertionError("config stale prepare: accepted")
        say(f"{CFG_FRESH} fresh clients on {CFG_OLD}: {chased} moved errors "
            "(one each), then translated (a bulk of 100 each, none more); "
            f"the moved text byte-equal to moved_message: {want!r}; the "
            "revert (version 4) deleted the fwindow self-rule and replayed "
            "onto the original table; a stale prepare answered "
            f"{stale[:60]!r}...")

        # -- check 8: tier-0's retire on a native server.
        retired = await _cfg_native_part(pkg, lc, wire, say)

        # -- check 9: OP_STATS, /metrics, the audit.
        stats = await cli.stats()
        text = await cli.metrics()
        if stats.get("config") != server.liveconfig.stats():
            raise AssertionError(f"config stats: {stats.get('config')}")
        fams = [ln for ln in text.splitlines()
                if ln.startswith("drl_config_") and not ln.startswith("#")]
        if "drl_config_commits_total 4" not in fams or \
                "drl_config_version 4" not in fams:
            raise AssertionError(f"config metrics: {fams}")
        server.auditor.tick()
        if server.auditor.breaches:
            raise AssertionError(f"config audit: {server.auditor.breaches} "
                                 "breaches")
        say(f"OP_STATS config {json.dumps(stats['config'])}; "
            f"{len(fams)} drl_config_* samples; audit clean; tier-0 "
            f"retired_config_rows {retired}")
    finally:
        ck.debit_packed = real_debit
        for c in [cli, solo, *extra]:
            await c.aclose()
        await server.aclose()
        await store.aclose()
    torch.cuda.synchronize()
    counts_out = dict(ck.launches)
    print(f"config path ({card}): {time.perf_counter() - t_path:.1f} s "
          "of wall")
    torch.cuda.empty_cache()
    return counts_out


# -- phase 18: drain-and-handoff shutdown -------------------------------------

DRAIN_SEED = 2121
#: Bucket keys: 1M, cut from BASELINE's 10M, as the config cell's. A drain
#: enumerates the whole store, as a config commit does.
DRAIN_KEYS = 1_000_000
DRAIN_CALL = 1_000_000
#: Three quarters of the keys stay at DRAIN_KEPT; a quarter load at
#: DRAIN_OLD, which version 1 retires for DRAIN_NEW (capacity 10 -> 6). The
#: store's clock is frozen; the rates are small so that the shutdown
#: envelope, which refills on the host's clock, gains under a token a key
#: over the drain.
DRAIN_KEPT = (10.0, 1.0 / 512)
DRAIN_OLD = (10.0, 1.0 / 1024)
DRAIN_NEW = (6.0, 1.0 / 1024)
DRAIN_WINDOW_KEYS = 100_000   # sliding windows (limit 100 a second)
DRAIN_COUNTERS = 10_000
DRAIN_SEMAS = 10_000          # semaphores of limit 5, 2 permits held
DRAIN_HOLDS = 300             # open reservations, 4 tokens each
DRAIN_TENANTS = 8
DRAIN_TENANT = (1e6, 1e-9)
DRAIN_HOLD_KEY = (100.0, 1e-9)
DRAIN_ASK_KEYS = 10_000       # asked through the source, then the successor
DRAIN_ASK_PAUSE_S = 0.5       # between the rounds through the source
DRAIN_WINDOW_S = 2.0
DRAIN_FAIL_KEYS = 100_000     # the failed drain's source
DRAIN_FAIL_SLOTS = 2**20
DRAIN_RETRY_KEYS = 10_000     # the source with no snapshot path


class _DrainSuccessor:
    """The successor handle a drain pushes into: the remote store, with its
    ``migrate_push`` timed (``on_first`` called as the first push starts:
    the import's phase begins) and, after the push that lands the ledger's
    rows, ``relay`` awaited (the settles the source relays while its gate
    is on). ``fail_at`` closes the successor's server before that push (a
    successor lost mid-push)."""

    def __init__(self, inner, relay=None, on_first=None, fail_at=None,
                 kill=None):
        self._inner = inner
        self._relay = relay
        self._on_first = on_first
        self._fail_at = fail_at
        self._kill = kill
        self.pushes = 0
        self.first_push_t = None
        self.last_push_t = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def migrate_push(self, req):
        if self.first_push_t is None:
            self.first_push_t = time.perf_counter()
            if self._on_first is not None:
                self._on_first()
        if self._fail_at is not None and self.pushes == self._fail_at:
            await self._kill()
        n = await self._inner.migrate_push(req)
        self.pushes += 1
        self.last_push_t = time.perf_counter()
        if self._relay is not None and req["entries"].get("reservations"):
            relay, self._relay = self._relay, None
            await relay()
        return n


def _drain_check_buckets(buckets, spend, retired, holds_by_tenant,
                         settled) -> int:
    """Hold the successor's bucket rows to a host float32 oracle of what a
    drain ships, from the load alone: every row's ``max(0, tokens -
    headroom_budget(cap))`` (``debit_export``), the relayed settles' refunds
    on top. Raises on any missing, extra or differing row; returns the
    rows."""
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )

    f = np.float32

    def env(cap):
        return f(headroom_budget(cap, fraction=0.5, min_budget=1.0))

    spent = spend.astype(np.float32)
    old = np.maximum(f(0.0), f(10.0) - spent - env(10.0))
    new = np.maximum(f(0.0), np.maximum(f(0.0), f(6.0) - spent) - env(6.0))
    want = {DRAIN_KEPT: (np.nonzero(~retired)[0], old),
            DRAIN_OLD: (np.nonzero(retired)[0], old),
            # The rebase created a retired key on the new table only if it
            # had spent something.
            DRAIN_NEW: (np.nonzero(retired & (spend > 0))[0], new)}
    other = {(f"dh{j}", *DRAIN_HOLD_KEY): f(100.0) - f(4.0) - env(100.0)
             for j in range(DRAIN_HOLDS)}
    for t, n in holds_by_tenant.items():
        other[(t, *DRAIN_TENANT)] = (f(DRAIN_TENANT[0]) - f(4.0 * n)
                                     - env(DRAIN_TENANT[0]))
    for j, t in settled:  # actual 1 of 4: 3 back to both levels
        other[(f"dh{j}", *DRAIN_HOLD_KEY)] += f(3.0)
        other[(t, *DRAIN_TENANT)] += f(3.0)
    got = {cfg: ([], []) for cfg in want}
    got_other = {}
    for key, cap, rate, tokens, _age in buckets:
        rows = got.get((cap, rate))
        if rows is not None and key.startswith("dk"):
            rows[0].append(int(key[2:]))
            rows[1].append(tokens)
        else:
            got_other[(key, cap, rate)] = f(tokens)
    for cfg, (idx, values) in want.items():
        gi = np.asarray(got[cfg][0], np.int64)
        order = np.argsort(gi)
        gi = gi[order]
        gt = np.asarray(got[cfg][1], np.float32)[order]
        if not np.array_equal(gi, idx):
            raise AssertionError(f"drain import: the rows at {cfg} are not "
                                 f"the shipped keys ({len(gi)} != "
                                 f"{len(idx)})")
        bad = np.nonzero(gt != values[idx])[0]
        if len(bad):
            i = int(gi[bad[0]])
            raise AssertionError(
                f"drain import: {len(bad)} balances at {cfg} differ from "
                f"the oracle (dk{i}: {gt[bad[0]]} != {values[i]})")
    if got_other != other:
        raise AssertionError("drain import: the holds' rows differ from the "
                             "oracle")
    return len(buckets)


async def _drain_failed(pkg, say, tmp: str) -> None:
    """Phase 4: a drain whose successor is lost mid-push falls back to the
    final checkpoint, which restores equal to the debited source; a source
    with no snapshot path raises, disarms its gate and drains on a retry."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    clock = pkg.ManualClock(1_000_000)
    path = os.path.join(tmp, "drain-fallback.snap")
    src_store = pkg.DeviceBucketStore(device="cuda", n_slots=DRAIN_FAIL_SLOTS,
                                      clock=clock)
    dst_store = pkg.DeviceBucketStore(device="cuda", n_slots=DRAIN_FAIL_SLOTS,
                                      clock=clock)
    src = pkg.BucketStoreServer(src_store, host="127.0.0.1", port=0,
                                snapshot_path=path)
    dst = pkg.BucketStoreServer(dst_store, host="127.0.0.1", port=0)
    a_src, a_dst = await src.start(), await dst.start()
    cli = pkg.RemoteBucketStore(address=a_src, request_timeout_s=300.0)
    succ = pkg.RemoteBucketStore(address=a_dst, coalesce_requests=False,
                                 request_timeout_s=5.0, retry_policy=None)
    fresh = None
    try:
        keys = [f"fk{i}" for i in range(DRAIN_FAIL_KEYS)]
        spend = np.random.default_rng(DRAIN_SEED + 1).integers(
            1, 11, DRAIN_FAIL_KEYS)
        res = await cli.acquire_many(keys, spend, *DRAIN_KEPT,
                                     with_remaining=False)
        if res.granted_count != DRAIN_FAIL_KEYS:
            raise AssertionError("drain fallback: a fresh key was denied")
        handle = _DrainSuccessor(succ, fail_at=1, kill=dst.aclose)
        t = time.perf_counter()
        summary = await src.shutdown(handle, window_s=DRAIN_WINDOW_S)
        fail_s = time.perf_counter() - t
        if ("drain_error" not in summary or summary.get("checkpoint") != path
                or summary["shipped_rows"] != 0):
            raise AssertionError(f"drain fallback: summary {summary}")
        if src._drain_envelope is not None:
            raise AssertionError("drain fallback: the gate stayed armed")
        fresh = pkg.DeviceBucketStore(device="cuda", n_slots=DRAIN_FAIL_SLOTS,
                                      clock=clock)
        t = time.perf_counter()
        await asyncio.to_thread(checkpoint.load_snapshot_chain, fresh, path)
        restore_s = time.perf_counter() - t
        _snapshots_equal("drain fallback", src_store.snapshot(),
                         fresh.snapshot())
        res = await fresh.acquire_many(keys, np.zeros(DRAIN_FAIL_KEYS,
                                                      np.int64), *DRAIN_KEPT)
        want = np.minimum(np.float32(10.0) - spend.astype(np.float32),
                          np.float32(5.0))
        if not np.array_equal(np.asarray(res.remaining, np.float32), want):
            raise AssertionError("drain fallback: a restored balance is not "
                                 "the debited source's")
        say(f"failed drain ({DRAIN_FAIL_KEYS:,} keys, the successor closed "
            f"after push 1 of {handle.pushes + 1}): {fail_s:.2f} s to the "
            f"fallback, summary {summary['drain_error'][:60]!r}..., the "
            f"checkpoint restored in {restore_s:.2f} s equals the debited "
            "source (every key min(balance, envelope 5))")
    finally:
        for c in (cli, succ):
            await c.aclose()
        await src.aclose()
        await dst.aclose()
        for s in (src_store, dst_store, fresh):
            if s is not None:
                await s.aclose()
    # A source with no snapshot path: the failure re-opens the shutdown.
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=2**16, clock=clock)
              for _ in range(2)]
    servers = [pkg.BucketStoreServer(s, host="127.0.0.1", port=0)
               for s in stores]
    addrs = [await s.start() for s in servers]
    gone = pkg.BucketStoreServer(pkg.InProcessBucketStore(), port=0)
    dead_addr = await gone.start()
    await gone.aclose()
    cli = pkg.RemoteBucketStore(address=addrs[0], request_timeout_s=60.0)
    dead = pkg.RemoteBucketStore(address=dead_addr, coalesce_requests=False,
                                 request_timeout_s=2.0, retry_policy=None)
    succ = pkg.RemoteBucketStore(address=addrs[1], coalesce_requests=False,
                                 request_timeout_s=60.0)
    try:
        keys = [f"rk{i}" for i in range(DRAIN_RETRY_KEYS)]
        await cli.acquire_many(keys, np.ones(DRAIN_RETRY_KEYS, np.int64),
                               *DRAIN_KEPT, with_remaining=False)
        try:
            await servers[0].shutdown(dead, window_s=0.0)
        except Exception as exc:  # noqa: BLE001 — the failure is the check
            err = type(exc).__name__
        else:
            raise AssertionError("drain retry: a drain into a dead "
                                 "successor returned")
        if servers[0]._drain_envelope is not None:
            raise AssertionError("drain retry: the gate stayed armed")
        r = await cli.acquire(keys[0], 0, *DRAIN_KEPT)
        if not r.granted or r.remaining != 5.0:
            raise AssertionError(f"drain retry: the source serves {r}")
        summary = await servers[0].shutdown(succ, window_s=0.0)
        if summary.get("shipped_rows") != DRAIN_RETRY_KEYS:
            raise AssertionError(f"drain retry: {summary}")
        say(f"no snapshot path: the drain into a dead successor raised "
            f"{err}, the gate disarmed (the source serves its residual "
            f"{r.remaining}), the retry shipped {summary['shipped_rows']:,} "
            "rows")
    finally:
        for c in (cli, dead, succ):
            await c.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()


async def drain_path(torch, ck, pkg, card: str) -> dict:
    """Drain-and-handoff shutdown (phase 18): the exact cell's server,
    restarted in a rolling way. A source and a successor
    ``BucketStoreServer``, each over a card ``DeviceBucketStore`` of 2^24
    slots on one frozen ManualClock; the source loaded over the wire with
    1M bucket keys (spends 0-10; a quarter at a config version 1 retires,
    capacity 10 -> 6), 100,000 sliding windows, 10,000 counters and
    semaphores, 300 open holds; ``shutdown(successor, window_s=2.0)`` with
    asks on 10,000 keys through the source while its gate is on and two
    holds settled through it (relayed), then the asks through the
    successor. Checks: the successor's rows against a host float32 oracle
    of ``debit_export``, admitted(source) + admitted(successor) <= the
    pre-drain balance + one envelope key by key, ``shipped_rows``, the
    forwarded config and its one chase, the relayed settles; then a failed
    drain's fallback checkpoint and a retried one. Returns the path's
    launches."""
    import shutil
    import tempfile

    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import (
        placement as pl,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    t_path = time.perf_counter()
    rng = np.random.default_rng(DRAIN_SEED)
    ck.reset_launches()

    def say(line: str) -> None:
        print(f"drain path ({card}) "
              f"[{time.perf_counter() - t_path:.1f} s]: {line}", flush=True)

    clock = pkg.ManualClock(1_000_000)
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                    counter_slots=2**15, clock=clock)
              for _ in range(2)]
    servers = [pkg.BucketStoreServer(s, host="127.0.0.1", port=0)
               for s in stores]
    addrs = [await s.start() for s in servers]
    cli = pkg.RemoteBucketStore(address=addrs[0], request_timeout_s=900.0)
    solo = pkg.RemoteBucketStore(address=addrs[0], coalesce_requests=False,
                                 request_timeout_s=900.0)
    asker = pkg.RemoteBucketStore(address=addrs[0], coalesce_requests=False,
                                  request_timeout_s=900.0, retry_policy=None)
    succ = pkg.RemoteBucketStore(address=addrs[1], coalesce_requests=False,
                                 request_timeout_s=900.0)
    extra = []
    real_debit = ck.debit_packed
    tmp = tempfile.mkdtemp(prefix="drl-drain-")
    try:
        # -- the load, over the wire.
        t = time.perf_counter()
        keys = [f"dk{i}" for i in range(DRAIN_KEYS)]
        spend = rng.integers(0, 11, DRAIN_KEYS)
        retired = rng.random(DRAIN_KEYS) < 0.25
        for cfg, mask in ((DRAIN_KEPT, ~retired), (DRAIN_OLD, retired)):
            idx = np.nonzero(mask)[0]
            for pos in range(0, len(idx), DRAIN_CALL):
                part = idx[pos:pos + DRAIN_CALL]
                res = await cli.acquire_many(
                    [keys[i] for i in part], spend[part], *cfg,
                    with_remaining=False)
                if res.granted_count != len(part):
                    raise AssertionError("drain load: a fresh key was "
                                         "denied")
        load_s = time.perf_counter() - t
        wkeys = [f"dw{i}" for i in range(DRAIN_WINDOW_KEYS)]
        wcount = rng.integers(1, 51, DRAIN_WINDOW_KEYS)
        res = await cli.window_acquire_many(wkeys, wcount, 100.0, 1.0,
                                            with_remaining=False)
        if res.granted_count != DRAIN_WINDOW_KEYS:
            raise AssertionError("drain load: a window was denied")
        # Counters and semaphores in one launch each, in process (the wire
        # has no bulk frame for them).
        ckeys = [f"dc{i}" for i in range(DRAIN_COUNTERS)]
        cvals = rng.integers(1, 50, DRAIN_COUNTERS).astype(np.float64)
        await stores[0].sync_counters_many(ckeys, cvals, DECAY_PER_S)
        skeys = [f"ds{i}" for i in range(DRAIN_SEMAS)]
        got = await stores[0].concurrency_acquire_many(
            skeys, np.full(DRAIN_SEMAS, 2, np.int64), 5)
        if not np.asarray(got.granted).all():
            raise AssertionError("drain load: a semaphore refused")
        holds_by_tenant: dict = {}
        for j in range(DRAIN_HOLDS):
            tenant = f"dt{j % DRAIN_TENANTS}"
            r = await solo.reserve(f"dr{j}", tenant, f"dh{j}", 4.0,
                                   *DRAIN_TENANT, *DRAIN_HOLD_KEY,
                                   ttl_s=3600.0)
            if not r.granted:
                raise AssertionError(f"drain hold: {r}")
            holds_by_tenant[tenant] = holds_by_tenant.get(tenant, 0) + 1
        setup_s = time.perf_counter() - t - load_s
        t = time.perf_counter()
        await solo.config_announce({"prepare": {
            "kind": "bucket", "old": list(DRAIN_OLD),
            "new": list(DRAIN_NEW)}, "version": 1})
        if await solo.config_announce({"commit": 1}) != 1:
            raise AssertionError("drain config: version 1 did not commit")
        commit_s = time.perf_counter() - t
        say(f"{DRAIN_KEYS:,} bucket keys loaded over the wire in "
            f"{load_s:.1f} s ({DRAIN_KEYS / load_s / 1e6:.2f} M rows/s; "
            f"{int(retired.sum()):,} at {DRAIN_OLD}), "
            f"{DRAIN_WINDOW_KEYS:,} windows, {DRAIN_COUNTERS:,} counters, "
            f"{DRAIN_SEMAS:,} semaphores and {DRAIN_HOLDS} holds in "
            f"{setup_s:.1f} s more; version 1 {DRAIN_OLD} -> {DRAIN_NEW} "
            f"committed in {commit_s:.2f} s")

        # -- the drain, asked through the source while its gate is on.
        ask_idx = np.sort(rng.choice(DRAIN_KEYS, DRAIN_ASK_KEYS,
                                     replace=False))
        ask_ret = retired[ask_idx]
        groups = [([keys[i] for i in ask_idx[m]], cfg, np.nonzero(m)[0])
                  for m, cfg in ((~ask_ret, DRAIN_KEPT),
                                 (ask_ret, DRAIN_NEW))]
        before = np.where(ask_ret, np.maximum(0, 6 - spend[ask_idx]),
                          10 - spend[ask_idx]).astype(np.int64)
        env_of = np.where(ask_ret, 3, 5).astype(np.int64)
        admitted = np.zeros((2, DRAIN_ASK_KEYS), np.int64)

        async def ask_round(client, side: int) -> int:
            n = 0
            for ks, cfg, pos in groups:
                res = await client.acquire_many(
                    ks, np.ones(len(ks), np.int64), *cfg,
                    with_remaining=False)
                g = np.asarray(res.granted, np.int64)
                admitted[side, pos] += g
                n += int(g.sum())
            return n

        timer = stores[0]._lock = _HoldTimer(stores[0]._lock)
        export_s = [0.0]
        exported = {}
        real_export = stores[0].export_entries

        def export_entries(keep):
            t0 = time.perf_counter()
            try:
                exported["entries"] = out = real_export(keep)
                return out
            finally:
                export_s[0] += time.perf_counter() - t0

        stores[0].export_entries = export_entries
        debit = {"source": [0.0, 0], "import": [0.0, 0]}
        phase = ["source"]

        def timed_debit(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_debit(*args, **kwargs)
            end.record()
            end.synchronize()
            debit[phase[0]][0] += start.elapsed_time(end)
            debit[phase[0]][1] += 1
            return out

        settle_holds = [(0, "dt0"), (1, "dt1")]
        relayed = []

        async def relay():
            for j, tenant in settle_holds:
                if f"dr{j}" not in servers[1].reservations._entries:
                    raise AssertionError("drain relay: the hold did not "
                                         "ship")
                relayed.append(await solo.settle(f"dr{j}", tenant, 1.0))

        launch_before = {}

        def import_begins():
            phase[0] = "import"
            launch_before.update(ck.launches)

        handle = _DrainSuccessor(succ, relay=relay, on_first=import_begins)
        ck.debit_packed = timed_debit
        t_drain = time.perf_counter()
        task = asyncio.ensure_future(servers[0].shutdown(
            handle, window_s=DRAIN_WINDOW_S))
        try:
            while servers[0]._drain_envelope is None:
                if task.done():
                    await task
                    raise AssertionError("drain: the gate never armed")
                await asyncio.sleep(0.001)
            t_armed = time.perf_counter()
            rounds = []
            while not task.done():
                t = time.perf_counter()
                try:
                    await ask_round(asker, 0)
                except (ConnectionError, OSError, wire.RemoteStoreError,
                        pkg.StoreTimeoutError):
                    if not task.done():
                        await asyncio.sleep(0.01)
                        if not task.done():
                            raise
                    break
                rounds.append(time.perf_counter() - t)
                # A round every DRAIN_ASK_PAUSE_S: each is 10,000 envelope
                # decisions in Python on the loop the push shares.
                await asyncio.wait([task], timeout=DRAIN_ASK_PAUSE_S)
            summary = await task
        finally:
            ck.debit_packed = real_debit
            stores[0].export_entries = real_export
        t_closed = time.perf_counter()
        drain_s = t_closed - t_drain
        import_launches = {k: v - launch_before.get(k, 0)
                           for k, v in ck.launches.items()
                           if v > launch_before.get(k, 0)}
        push_s = handle.last_push_t - handle.first_push_t
        # From the gate's arming to the first push: the source debit (the
        # buckets' launches and the windows' charge to their limits).
        source_debit_s = handle.first_push_t - t_armed
        gate_s = t_closed - t_armed
        linger_s = max(0.0, t_closed - handle.last_push_t)
        if debit["source"][1] <= 0 or debit["import"][1] <= 0:
            raise AssertionError(f"drain: debit_packed launches {debit}")
        if len(relayed) != 2 or any(r.outcome != "settled" or
                                    r.refunded != 3.0 for r in relayed):
            raise AssertionError(f"drain relay: {relayed}")
        n_export = pl.entry_count(exported["entries"]) + DRAIN_HOLDS
        if summary["shipped_rows"] != n_export:
            raise AssertionError(f"drain: shipped_rows "
                                 f"{summary['shipped_rows']} != {n_export} "
                                 "exported rows")
        say(f"shutdown(successor, window_s={DRAIN_WINDOW_S}): the export "
            f"{export_s[0]:.2f} s, the store lock's longest hold "
            f"{timer.longest:.2f} s; the source debit {source_debit_s:.2f} "
            f"s, its debit_packed launches {debit['source'][1]}, "
            f"{debit['source'][0]:.3f} ms of CUDA events; the push {push_s:.2f} s for "
            f"{summary['shipped_rows']:,} rows "
            f"({summary['shipped_rows'] / push_s:,.0f} rows/s, "
            f"{handle.pushes} chunks), the import's launches "
            f"{json.dumps(import_launches)} (its debit_packed "
            f"{debit['import'][0]:.3f} ms of CUDA events); the linger "
            f"{linger_s:.2f} s after the last push (the gate on "
            f"{gate_s:.2f} s); envelope decisions "
            f"{summary['envelope_decisions']:,}; the drain {drain_s:.2f} s")
        say(f"asks through the source on {DRAIN_ASK_KEYS:,} keys while the "
            f"gate was on: {len(rounds)} rounds, the longest "
            f"{max(rounds, default=0.0):.2f} s (the serving stall), admitted "
            f"{int(admitted[0].sum()):,} from the envelope; two holds "
            "settled through the source, relayed: refunds "
            f"{[r.refunded for r in relayed]}")

        # -- check 3: the successor's state, in process.
        t = time.perf_counter()
        entries = await asyncio.to_thread(stores[1].export_entries,
                                          lambda _k: True)
        succ_export_s = time.perf_counter() - t
        n_rows = _drain_check_buckets(entries["buckets"], spend, retired,
                                      holds_by_tenant, settle_holds)
        wbudget = headroom_budget(100.0, fraction=0.5, min_budget=1.0)
        wgot = {k: (prev, curr) for k, _lim, _wt, _i, prev, curr, _b
                in entries["windows"]}
        wwant = np.minimum(100.0, wcount + wbudget)
        if (len(wgot) != DRAIN_WINDOW_KEYS
                or any(wgot[k] != (0.0, float(c))
                       for k, c in zip(wkeys, wwant))):
            raise AssertionError("drain import: a window differs from "
                                 "min(limit, count + envelope)")
        cgot = {k: v for k, v, _p, _a in entries["counters"]}
        if not np.array_equal(
                np.asarray([cgot[k] for k in ckeys], np.float32),
                cvals.astype(np.float32)):
            raise AssertionError("drain import: a counter differs")
        sgot = dict(entries["semas"])
        if len(sgot) != DRAIN_SEMAS or set(sgot.values()) != {2}:
            raise AssertionError("drain import: held permits differ")
        led = servers[1].reservations
        if (any(f"dr{j}" not in led._settled for j, _ in settle_holds)
                or len(led._entries) != DRAIN_HOLDS - 2):
            raise AssertionError("drain import: the ledger differs")
        if servers[1].liveconfig.version != 1:
            raise AssertionError("drain config: the successor's version is "
                                 f"{servers[1].liveconfig.version}")
        say(f"the successor's export ({succ_export_s:.1f} s): "
            f"{n_rows:,} bucket rows equal the host float32 oracle of "
            "debit_export (the relayed refunds included), "
            f"{DRAIN_WINDOW_KEYS:,} windows at min(limit, count + "
            f"{wbudget:.0f}), {DRAIN_COUNTERS:,} counters and "
            f"{DRAIN_SEMAS:,} semaphores equal, {len(led._entries)} holds "
            "open and the two relayed ones settled; shipped_rows "
            f"{summary['shipped_rows']:,} = the exported rows; config "
            f"version {servers[1].liveconfig.version}")

        # -- the asks through the successor, and the bound.
        succ_asker = pkg.RemoteBucketStore(address=addrs[1],
                                           coalesce_requests=False,
                                           request_timeout_s=900.0)
        extra.append(succ_asker)
        n_rounds = 0
        while await ask_round(succ_asker, 1):
            n_rounds += 1
        refill = np.where(ask_ret, DRAIN_NEW[1], DRAIN_KEPT[1]) * 0.5 \
            * (time.perf_counter() - t_armed)
        bound = before + env_of + np.floor(refill).astype(np.int64)
        total = admitted.sum(axis=0)
        over = total - bound
        if (over > 0).any():
            raise AssertionError(
                f"drain bound: {int((over > 0).sum())} keys admitted past "
                "their balance plus one envelope")
        say(f"asks through the successor: {n_rounds} rounds granted "
            f"{int(admitted[1].sum()):,}; source + successor admitted "
            f"{int(total.sum()):,} against pre-drain balances "
            f"{int(before.sum()):,} + envelopes {int(env_of.sum()):,}, "
            f"every key within its bound (max total - balance "
            f"{int((total - before).max())})")

        # -- the forwarded config: a fresh client chases once.
        moved_before = servers[1].liveconfig.moved_errors
        fresh = pkg.RemoteBucketStore(address=addrs[1],
                                      coalesce_requests=False)
        extra.append(fresh)
        # A retired key that spent 1 (shipped 5 - 3 = 2), never asked.
        i = int(np.nonzero(retired & (spend == 1) & ~np.isin(
            np.arange(DRAIN_KEYS), ask_idx))[0][0])
        r = await fresh.acquire(keys[i], 0, *DRAIN_OLD)
        chased = servers[1].liveconfig.moved_errors - moved_before
        want = 2.0
        if chased != 1 or r.remaining != want:
            raise AssertionError(f"drain config: {chased} chases, {r} "
                                 f"(want {want})")
        say(f"a fresh client at {DRAIN_OLD} on the successor chased "
            f"{chased} config moved error and read the shipped balance "
            f"{r.remaining} at {DRAIN_NEW}")

        # -- check 4: a failed drain and a retried one.
        await _drain_failed(pkg, say, tmp)
    finally:
        ck.debit_packed = real_debit
        for c in [cli, solo, asker, succ, *extra]:
            await c.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    counts_out = dict(ck.launches)
    print(f"drain path ({card}): {time.perf_counter() - t_path:.1f} s "
          "of wall")
    torch.cuda.empty_cache()
    return counts_out


# -- phase 19: the cluster and its controller ---------------------------------

CLUSTER_SEED = 2222
#: Bucket keys over the three nodes: 1M, cut from BASELINE's 10M for the
#: same time limit that cut the config and drain cells (the scale-out pulls
#: from every node, and a pull enumerates the whole store).
CLUSTER_KEYS = 1_000_000
CLUSTER_CALL = 250_000          # rows an acquire_many call of the fan-out
CLUSTER_CAP, CLUSTER_RATE = 10.0, 1.0
CLUSTER_WINDOW_KEYS = 100_000   # sliding windows, limit 3 a second
CLUSTER_WINDOW_ROWS = 250_000   # their unit asks, uniform over the keys
CLUSTER_WINDOW = (3.0, 1.0)     # limit, seconds
CLUSTER_COUNTERS = 10_000
CLUSTER_SEMAS = 10_000          # semaphores of limit 5, 2 permits held
CLUSTER_SEMA_LIMIT = 5
CLUSTER_LLM_BUDGETS = (1e6, 5e4)  # (key, tenant) tokens; the tenant binds
CLUSTER_LLM_RATE = 1e5
CLUSTER_PAIRS = 300             # reserve/settle pairs
CLUSTER_TENANT = (1e6, 10.0)    # the pairs' tenant budget
CLUSTER_HOLD_KEY = (1000.0, 10.0)
CLUSTER_ACQUIRES = 10_000       # routed single-key acquires
CLUSTER_PEEKS = 2_000
CLUSTER_TASKS = 32              # concurrent callers of the routed acquires
CLUSTER_OUTAGE_KEYS = 10_000    # node 1's keys asked during its outage
CLUSTER_OUTAGE_ROUNDS = 8       # unit asks a key (the envelope admits 5)
CLUSTER_DENY_ROWS = 30_000      # a no-fallback client's bulk in the outage
CLUSTER_BREAKER = (3, 30.0)     # failure threshold, recovery seconds
CLUSTER_CHASE_KEYS = 1_000      # moved keys a stale client sends
CLUSTER_ZIPF_KEYS = 100_000     # the controller's traffic
CLUSTER_ZIPF_DRAWS = 20_000     # a tick
#: Their bucket: a split leaves half of it on each side, so the rate keeps
#: its time to full inside the final sweep's two days.
CLUSTER_ZIPF_CAP = (1e6, 1000.0)
CLUSTER_STORM = 200             # retried reserves a storm tick
CLUSTER_CALM = 200              # plain acquires a calm tick
CLUSTER_CTL = dict(tick_s=1.0, split_share=0.1, split_min_tokens=100.0,
                   split_streak_ticks=2, cooldown_ticks=2)


class _ClusterOracle:
    """Host float32 balances of the path's bucket keys at one capacity
    (every key whole-numbered, the clock frozen: no refill)."""

    def __init__(self, n: int, cap: float) -> None:
        self.tok = np.full(n, np.float32(cap), np.float32)

    def take(self, idx: np.ndarray, counts: np.ndarray) -> tuple:
        """Distinct ``idx`` asking ``counts``: (granted, remaining)."""
        counts = counts.astype(np.float32)
        granted = self.tok[idx] >= counts
        self.tok[idx] = np.where(granted, self.tok[idx] - counts,
                                 self.tok[idx])
        return granted, self.tok[idx].copy()


def _check_rows(what, got_granted, got_remaining, granted,
                remaining) -> None:
    """Rows' grants (and, unless ``remaining`` is None, their remaining)
    equal the oracle's."""
    g = np.asarray(got_granted, bool)
    if not np.array_equal(g, granted):
        bad = int(np.nonzero(g != granted)[0][0])
        raise AssertionError(f"{what}: row {bad} granted {g[bad]}, oracle "
                             f"{granted[bad]}")
    if remaining is not None:
        r = np.asarray(got_remaining, np.float32)
        if not np.array_equal(r, remaining):
            bad = int(np.nonzero(r != remaining)[0][0])
            raise AssertionError(f"{what}: row {bad} remaining {r[bad]}, "
                                 f"oracle {remaining[bad]}")


async def _cluster_load(pkg, cluster, stores, rng, oracle, keys) -> dict:
    """Step 1: the fan-out's load against host oracles."""
    out = {}
    counts = rng.integers(1, 4, CLUSTER_KEYS)
    t = time.perf_counter()
    for pos in range(0, CLUSTER_KEYS, CLUSTER_CALL):
        idx = np.arange(pos, min(pos + CLUSTER_CALL, CLUSTER_KEYS))
        res = await cluster.acquire_many([keys[i] for i in idx],
                                         counts[idx], CLUSTER_CAP,
                                         CLUSTER_RATE)
        _check_rows("cluster load", res.granted, res.remaining,
                    *oracle.take(idx, counts[idx]))
    out["fan_s"] = time.perf_counter() - t
    # Windows: unit asks, uniform over the keys, against the window path's
    # serial oracle (all at one frozen tick).
    limit, window_s = CLUSTER_WINDOW
    wkeys = [f"cw{i}" for i in range(CLUSTER_WINDOW_KEYS)]
    wrows = rng.integers(0, CLUSTER_WINDOW_KEYS, CLUSTER_WINDOW_ROWS)
    now = stores[0].clock.now_ticks()
    wo = _WindowOracle(limit, int(window_s * 1024))
    want = np.array([wo.decide(wkeys[i], 1, now) for i in wrows.tolist()],
                    bool)
    curr = {}
    rem = np.empty(len(wrows), np.float32)
    for n, (i, g) in enumerate(zip(wrows.tolist(), want.tolist())):
        curr[i] = curr.get(i, 0) + int(g)
        rem[n] = np.float32(max(limit - curr[i], 0.0))
    t = time.perf_counter()
    res = await cluster.window_acquire_many([wkeys[i] for i in wrows],
                                            np.ones(len(wrows), np.int64),
                                            limit, window_s)
    out["window_s"] = time.perf_counter() - t
    _check_rows("cluster windows", res.granted, res.remaining, want, rem)
    out["window_denied"] = int((~want).sum())
    # Counters and semaphores, one routed op a key, gathered.
    ckeys = [f"cc{i}" for i in range(CLUSTER_COUNTERS)]
    cvals = rng.integers(1, 50, CLUSTER_COUNTERS).astype(np.float64)
    skeys = [f"cs{i}" for i in range(CLUSTER_SEMAS)]
    t = time.perf_counter()
    for pos in range(0, CLUSTER_COUNTERS, 1000):
        got = await asyncio.gather(*(
            cluster.sync_counter(ckeys[i], float(cvals[i]), DECAY_PER_S)
            for i in range(pos, min(pos + 1000, CLUSTER_COUNTERS))))
        score = np.array([r.global_score for r in got], np.float32)
        if not np.array_equal(score, cvals[pos:pos + 1000]
                              .astype(np.float32)):
            raise AssertionError("cluster counters: a score differs")
    for pos in range(0, CLUSTER_SEMAS, 1000):
        got = await asyncio.gather(*(
            cluster.concurrency_acquire(k, 2, CLUSTER_SEMA_LIMIT)
            for k in skeys[pos:pos + 1000]))
        if not all(r.granted for r in got):
            raise AssertionError("cluster semaphores: a fresh one refused")
    out["ops_s"] = time.perf_counter() - t
    # Two-level rows of the LLM workload, by tenant; each tenant's rows held
    # to a CPU store on the same clock (the plain versions on the host).
    tenants, hkeys, costs, _ = _llm_workload(LLM_SEED, LLM_ROWS)
    kcap, tcap = CLUSTER_LLM_BUDGETS
    t = time.perf_counter()
    res = await cluster.acquire_hierarchical_many(
        tenants, hkeys, costs, tcap, CLUSTER_LLM_RATE, kcap,
        CLUSTER_LLM_RATE)
    out["hier_s"] = time.perf_counter() - t
    host = pkg.DeviceBucketStore(device="cpu", n_slots=LLM_SLOTS,
                                 clock=stores[0].clock)
    want_g = np.zeros(LLM_ROWS, bool)
    want_r = np.zeros(LLM_ROWS, np.float32)
    by_tenant: dict = {}
    for i, tn in enumerate(tenants):
        by_tenant.setdefault(tn, []).append(i)
    for tn, idx in by_tenant.items():
        r = await host.acquire_hierarchical_many(
            [tn] * len(idx), [hkeys[i] for i in idx], costs[idx], tcap,
            CLUSTER_LLM_RATE, kcap, CLUSTER_LLM_RATE)
        want_g[idx] = r.granted
        want_r[idx] = r.remaining
    await host.aclose()
    # Grants exactly; remaining within two float32 spacings of the value
    # (a tenant's prefix past 2^24 tokens rounds, in both alike or not).
    _check_rows("cluster two-level", res.granted, None, want_g, None)
    err = np.abs(np.asarray(res.remaining, np.float32) - want_r)
    if (err > 2 * np.spacing(np.maximum(np.abs(want_r),
                                        np.float32(1.0)))).any():
        raise AssertionError(f"cluster two-level: remaining off by "
                             f"{err.max()}")
    out["hier_err"] = float(err.max())
    admitted = _tenant_totals(tenants, costs, res.granted)
    if max(admitted.values()) > tcap:
        raise AssertionError(f"cluster two-level: a tenant admitted "
                             f"{max(admitted.values())} > {tcap}")
    out["hier_denied"] = int((~want_g).sum())
    out["hier_tokens"] = int(costs[want_g].sum())
    # Reserve/settle pairs.
    t = time.perf_counter()
    settled = 0
    for i in range(CLUSTER_PAIRS):
        tn = f"crt{i % 8}"
        r = await cluster.reserve(f"crid{i}", tn, f"{tn}/k{i % 50}", 8.0,
                                  *CLUSTER_TENANT, *CLUSTER_HOLD_KEY,
                                  ttl_s=3600.0)
        if not r.granted or r.reserved != 8.0:
            raise AssertionError(f"cluster reserve {i}: {r}")
        s = await cluster.settle(f"crid{i}", tn, float(i % 8))
        settled += s.outcome == "settled"
    if settled != CLUSTER_PAIRS:
        raise AssertionError(f"cluster settles: {settled} settled")
    out["pairs_s"] = time.perf_counter() - t
    out["ckeys"], out["skeys"], out["wkeys"] = ckeys, skeys, wkeys
    return out


async def _cluster_singles(cluster, addrs, rng, oracle, keys, wire_solo,
                           say) -> None:
    """Step 2: routed single-key ops, p50/p99, OP_STATS rows per node and
    the fleet scrape."""
    clis = [wire_solo(a) for a in addrs[:3]]
    before = [(await c.stats())["store"]["rows_valid"] for c in clis]
    idx = rng.choice(CLUSTER_KEYS, CLUSTER_ACQUIRES, replace=False)
    lat, got = [], {}
    it = iter(idx.tolist())

    async def worker():
        for i in it:
            t = time.perf_counter()
            got[i] = await cluster.acquire(keys[i], 1, CLUSTER_CAP,
                                           CLUSTER_RATE)
            lat.append(time.perf_counter() - t)

    t_acq = time.perf_counter()
    await asyncio.gather(*(worker() for _ in range(CLUSTER_TASKS)))
    t_acq = time.perf_counter() - t_acq
    g, rem = oracle.take(idx, np.ones(len(idx), np.int64))
    _check_rows("cluster acquire", [got[i].granted for i in idx.tolist()],
                [got[i].remaining for i in idx.tolist()], g, rem)
    after = [(await c.stats())["store"]["rows_valid"] for c in clis]
    routed = np.bincount([cluster.node_index_of(keys[i]) for i in idx],
                         minlength=3)
    rows = [a - b for a, b in zip(after, before)]
    if rows != routed.tolist():
        raise AssertionError(f"cluster routing: OP_STATS rows {rows}, "
                             f"node_index_of {routed.tolist()}")
    plat = []
    pidx = rng.choice(CLUSTER_KEYS, CLUSTER_PEEKS, replace=False)
    for i in pidx.tolist():
        t = time.perf_counter()
        v = await asyncio.to_thread(cluster.peek_blocking, keys[i],
                                    CLUSTER_CAP, CLUSTER_RATE)
        plat.append(time.perf_counter() - t)
        if np.float32(v) != oracle.tok[i]:
            raise AssertionError(f"cluster peek {keys[i]}: {v} != "
                                 f"{oracle.tok[i]}")
    # The fleet scrape: each summed series is the sum of its node series.
    text = await cluster.cluster_metrics()
    from distributedratelimiting.redis_tpu_torch.utils import metrics as pm

    _, samples = pm.parse_openmetrics(text)
    checked = 0
    for fam in ("drl_requests_served_total", "drl_admitted_tokens_total",
                "drl_connections_served_total"):
        per = [v for n, lb, v in samples if n == fam
               and dict(lb).get("node") is not None]
        tot = [v for n, lb, v in samples if n == fam
               and dict(lb).get("node") is None]
        if len(per) != 3 or tot != [sum(per)]:
            raise AssertionError(f"cluster_metrics {fam}: {tot} != "
                                 f"sum {per}")
        checked += 1
    for c in clis:
        await c.aclose()
    say(f"routed: {CLUSTER_ACQUIRES:,} acquire from {CLUSTER_TASKS} tasks, "
        f"p50 {_pct(lat, 50) * 1e3:.3f} ms, p99 {_pct(lat, 99) * 1e3:.3f} "
        f"ms ({CLUSTER_ACQUIRES / t_acq:,.0f} requests/s); "
        f"{CLUSTER_PEEKS:,} peek_blocking one at a time, p50 "
        f"{_pct(plat, 50) * 1e3:.3f} ms, p99 {_pct(plat, 99) * 1e3:.3f} ms; "
        "grants, remaining and "
        f"peeks equal the oracle; OP_STATS rows by node {rows} = "
        f"node_index_of; cluster_metrics() sums equal the node series "
        f"({checked} families)")


async def _cluster_outage(pkg, cluster, stores, servers, addrs, rng, oracle,
                          keys, bclock, fr, remote_kw, say) -> None:
    """Step 3: node 1's outage, the breaker, the deny and degraded rows,
    the restart, the probe and the rejoin debit."""
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import (
        placement as pl,
    )

    owner = cluster.placement.route(keys)
    on1 = np.nonzero(owner == 1)[0]
    asked = rng.choice(on1, CLUSTER_OUTAGE_KEYS, replace=False)
    others = rng.choice(np.nonzero(owner != 1)[0], CLUSTER_OUTAGE_KEYS,
                        replace=False)
    pre = oracle.tok[asked].copy()
    await servers[1].aclose()
    t_out = time.perf_counter()
    grants = np.zeros(CLUSTER_OUTAGE_KEYS, np.int64)
    states = []
    for rnd in range(CLUSTER_OUTAGE_ROUNDS):
        rows = np.concatenate([asked, others]) if rnd == 0 else asked
        res = await cluster.acquire_many([keys[i] for i in rows],
                                         np.ones(len(rows), np.int64),
                                         CLUSTER_CAP, CLUSTER_RATE)
        g = np.asarray(res.granted, bool)
        grants += g[:CLUSTER_OUTAGE_KEYS]
        if rnd == 0:  # nodes 0 and 2 decide exactly
            m = len(asked)
            _check_rows("outage: nodes 0 and 2", g[m:],
                        np.asarray(res.remaining)[m:],
                        *oracle.take(others, np.ones(len(others), np.int64)))
        states.append(cluster._breakers[1].state)
    t_deg = time.perf_counter() - t_out
    thr = CLUSTER_BREAKER[0]
    if states[thr - 1:] != ["open"] * (CLUSTER_OUTAGE_ROUNDS - thr + 1) \
            or "open" in states[:thr - 1]:
        raise AssertionError(f"outage: breaker states by round {states}")
    budget = headroom_budget(CLUSTER_CAP, fraction=0.5, min_budget=1.0)
    refill = 0.5 * CLUSTER_RATE * t_deg
    if grants.max() > budget + refill or grants.min() < min(budget, 1):
        raise AssertionError(f"outage: a key admitted {grants.max()} "
                             f"(budget {budget} + refill {refill:.2f})")
    # The deny rule: a client with no fallback denies node 1's rows.
    deny = pkg.ClusterBucketStore(addresses=addrs[:3],
                                  partial_failures="deny", **remote_kw)
    deny.placement = cluster.placement
    drows = rng.choice(CLUSTER_KEYS, CLUSTER_DENY_ROWS, replace=False)
    res = await deny.acquire_many([keys[i] for i in drows],
                                  np.ones(len(drows), np.int64), CLUSTER_CAP,
                                  CLUSTER_RATE)
    d1 = owner[drows] == 1
    if np.asarray(res.granted)[d1].any() or \
            np.asarray(res.remaining)[d1].any():
        raise AssertionError("outage: a deny row of node 1 was granted")
    _check_rows("outage: deny client's live rows",
                np.asarray(res.granted)[~d1], np.asarray(res.remaining)[~d1],
                *oracle.take(drows[~d1], np.ones(int((~d1).sum()),
                                                  np.int64)))
    await deny.aclose()
    text_open = cluster.metrics_registry().render()
    if 'drl_cluster_breaker_state{node="1"} 2' not in text_open:
        raise AssertionError("outage: the gauge does not read open")
    # Restart over the same store on the same port; the probe re-closes.
    srv = pkg.BucketStoreServer(stores[1], host=addrs[1][0],
                                port=addrs[1][1])
    srv.placement = pl.NodePlacementState(clock=stores[1].clock.now_seconds)
    await srv.start()
    servers[1] = srv
    node1 = cluster.nodes[1]
    for _ in range(200):
        if not node1.resilience_stats()["backing_off"]:
            break
        await asyncio.sleep(0.01)
    bclock[0] += CLUSTER_BREAKER[1] + 1.0
    probes = cluster._breakers[1].probes
    r = await cluster.acquire(keys[int(asked[0])], 0, CLUSTER_CAP,
                              CLUSTER_RATE)
    if cluster._breakers[1].state != "closed" or \
            cluster._breakers[1].probes != probes + 1:
        raise AssertionError(f"rejoin: breaker {cluster._breakers[1].state}"
                             f" after {cluster._breakers[1].probes - probes}"
                             " probes")
    t = time.perf_counter()
    while cluster._bg_tasks and time.perf_counter() - t < 300:
        await asyncio.sleep(0.01)
    debit_s = time.perf_counter() - t
    if cluster._bg_tasks:
        raise AssertionError("rejoin: the debit did not finish")
    n_debited = int((grants > 0).sum())
    if cluster.rejoin_debits != n_debited:
        raise AssertionError(f"rejoin: {cluster.rejoin_debits} debits, "
                             f"{n_debited} keys with degraded grants")
    want = np.maximum(np.float32(0.0), pre - grants.astype(np.float32))
    got = await stores[1].acquire_many([keys[i] for i in asked],
                                       np.zeros(len(asked), np.int64),
                                       CLUSTER_CAP, CLUSTER_RATE)
    if not np.array_equal(np.asarray(got.remaining, np.float32), want):
        bad = int(np.nonzero(np.asarray(got.remaining) != want)[0][0])
        raise AssertionError(f"rejoin: {keys[int(asked[bad])]} holds "
                             f"{got.remaining[bad]}, oracle {want[bad]}")
    oracle.tok[asked] = want
    trans = [(f["node"], f["old"], f["new"])
             for f in fr.frames(kind="breaker")]
    if trans != [(1, "closed", "open"), (1, "open", "half_open"),
                 (1, "half_open", "closed")]:
        raise AssertionError(f"outage: flight frames {trans}")
    if 'drl_cluster_breaker_state{node="1"} 0' not in \
            cluster.metrics_registry().render():
        raise AssertionError("rejoin: the gauge does not read closed")
    say(f"outage of node 1: {CLUSTER_OUTAGE_ROUNDS} bulk rounds of unit "
        f"asks on {CLUSTER_OUTAGE_KEYS:,} of its keys in {t_deg:.2f} s; "
        f"breaker open from round {thr} (flight frames and "
        "drl_cluster_breaker_state), degraded grants a key "
        f"{grants.min()}-{grants.max()} <= {budget:.0f} + {refill:.2f} "
        f"refill, {cluster.degraded_decisions:,} degraded decisions; nodes "
        f"0 and 2 exact; a deny client's {int(d1.sum()):,} node-1 rows "
        "denied; restart on the same port, one probe closed the breaker "
        f"({r.remaining:.0f} read); {cluster.rejoin_debits:,} rejoin debits "
        f"in {debit_s:.2f} s, every asked key's balance = max(0, "
        "pre-outage - degraded grants)")


async def _cluster_scale_out(torch, ck, pkg, cluster, stores, addrs, rng,
                             oracle, keys, remote_kw, say) -> None:
    """Step 4: ``add_node`` of a fourth server, the moved and unmoved
    balances, and a stale client's MOVED chase."""
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import (
        placement as pl,
    )

    pmap0 = cluster.placement
    timers = [_HoldTimer(s._lock) for s in stores[:3]]
    for s, tm in zip(stores[:3], timers):
        s._lock = tm
    # The pull and the push timed on the client class: the new node's
    # client is made inside add_node.
    pull_s, push_s, pushed = [0.0], [0.0], [0]
    remote = pkg.RemoteBucketStore
    real_pull, real_push = remote.migrate_pull, remote.migrate_push

    async def timed_pull(self, req, **kw):
        t = time.perf_counter()
        try:
            return await real_pull(self, req, **kw)
        finally:
            pull_s[0] += time.perf_counter() - t

    async def timed_push(self, req, **kw):
        t = time.perf_counter()
        try:
            n = await real_push(self, req, **kw)
            pushed[0] += n
            return n
        finally:
            push_s[0] += time.perf_counter() - t

    debit_ms = [0.0, 0]
    real_debit = ck.debit_packed

    def timed_debit(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_debit(*args, **kwargs)
        end.record()
        end.synchronize()
        debit_ms[0] += start.elapsed_time(end)
        debit_ms[1] += 1
        return out

    launches0 = dict(ck.launches)
    ck.debit_packed = timed_debit
    remote.migrate_pull, remote.migrate_push = timed_pull, timed_push
    t = time.perf_counter()
    try:
        j = await cluster.add_node(address=addrs[3])
    finally:
        ck.debit_packed = real_debit
        remote.migrate_pull, remote.migrate_push = real_pull, real_push
        for s, tm in zip(stores[:3], timers):
            s._lock = tm._lock
    add_s = time.perf_counter() - t
    launches = {k: v - launches0.get(k, 0) for k, v in ck.launches.items()
                if v > launches0.get(k, 0)}
    if j != 3 or cluster.placement.epoch != pmap0.epoch + 1:
        raise AssertionError(f"add_node: node {j}, epoch "
                             f"{cluster.placement.epoch}")
    owner0 = pmap0.route(keys)
    owner1 = cluster.placement.route(keys)
    moved = np.nonzero(owner0 != owner1)[0]
    kept = np.nonzero(owner0 == owner1)[0]
    if not len(moved) or (owner1[moved] != 3).any():
        raise AssertionError("add_node: nothing moved, or not to node 3")
    budget = headroom_budget(CLUSTER_CAP, fraction=0.5, min_budget=1.0)
    shipped = np.maximum(np.float32(0.0),
                         oracle.tok[moved] - np.float32(budget))
    res = await stores[3].acquire_many([keys[i] for i in moved],
                                       np.zeros(len(moved), np.int64),
                                       CLUSTER_CAP, CLUSTER_RATE)
    if not np.array_equal(np.asarray(res.remaining, np.float32), shipped):
        raise AssertionError("add_node: a moved balance differs from the "
                             "host oracle of debit_export")
    for n in range(3):
        mine = kept[owner0[kept] == n]
        res = await stores[n].acquire_many(
            [keys[i] for i in mine], np.zeros(len(mine), np.int64),
            CLUSTER_CAP, CLUSTER_RATE)
        if not np.array_equal(np.asarray(res.remaining, np.float32),
                              oracle.tok[mine]):
            raise AssertionError(f"add_node: an unmoved balance on node "
                                 f"{n} changed")
    oracle.tok[moved] = shipped
    hold = max(tm.longest for tm in timers)
    say(f"scale-out: add_node(address=...) -> node 3, epoch "
        f"{cluster.placement.epoch}, {len(moved):,} of {CLUSTER_KEYS:,} "
        f"bucket keys moved, in {add_s:.1f} s: pull {pull_s[0]:.1f} s, the "
        f"store lock's longest hold {hold:.2f} s, push {push_s[0]:.1f} s, "
        f"{pushed[0]:,} rows ({pushed[0] / max(push_s[0], 1e-9):,.0f} "
        f"rows/s), the import's debit_packed {debit_ms[1]} launches at "
        f"{debit_ms[0]:.2f} ms of CUDA events; launches {json.dumps(launches)}"
        f"; moved balances = the host oracle of debit_export, "
        f"{len(kept):,} unmoved unchanged")
    # A second client still at epoch 0: each moved key chases one MOVED.
    stale = pkg.ClusterBucketStore(addresses=addrs,
                                   placement=pl.PlacementMap.initial(3),
                                   **remote_kw)
    refreshes = [0]
    real_refresh = stale.refresh_placement

    async def counted_refresh():
        refreshes[0] += 1
        return await real_refresh()

    stale.refresh_placement = counted_refresh
    sample = rng.choice(moved, CLUSTER_CHASE_KEYS, replace=False)
    t = time.perf_counter()
    for i in sample.tolist():
        stale.placement = pl.PlacementMap.initial(3)
        refreshes[0] = 0
        r = await stale.acquire(keys[i], 1, CLUSTER_CAP, CLUSTER_RATE)
        g, rem = oracle.take(np.array([i]), np.ones(1, np.int64))
        if refreshes[0] != 1 or stale.node_index_of(keys[i]) != 3 or \
                r.granted != g[0] or np.float32(r.remaining) != rem[0]:
            raise AssertionError(f"chase {keys[i]}: {refreshes[0]} "
                                 f"refreshes, {r}, oracle {g[0]} {rem[0]}")
    chase_s = time.perf_counter() - t
    await stale.aclose()
    say(f"MOVED chase: {CLUSTER_CHASE_KEYS:,} moved keys from a client at "
        f"epoch 0, each one refresh and one re-route to node 3, in "
        f"{chase_s:.2f} s; grants and remaining = the oracle")


async def _cluster_controller(cluster, stores, servers, addrs, rng,
                              say) -> None:
    """Step 5: the controller ticked by hand: the hot split, the
    retry-storm rung on every server, the dry-run twin, the surfaces."""
    import types

    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        headroom_budget,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import controller
    from distributedratelimiting.redis_tpu_torch.utils import faults

    cfg = controller.ControllerConfig(**CLUSTER_CTL)
    ctl = controller.Controller(cluster, config=cfg, shed_targets=servers,
                                flight_recorder=cluster.flight_recorder)
    servers[0].controller = ctl
    twin = controller.Controller(types.SimpleNamespace(), config=(
        controller.ControllerConfig(**CLUSTER_CTL, dry_run=True)))
    scrape = ctl.scrape
    sensors = []

    async def recorded():
        s = await scrape()
        sensors.append(s)
        return s

    ctl.scrape = recorded
    live, dry = [], []

    async def tick():
        recs = await ctl.tick()
        twin._tick = sensors[-1].tick
        live.append([(r["action"], r["target"], r["reason"])
                     for r in recs])
        dry.append([(i["action"], i["target"], i["reason"])
                    for i in twin.decide(sensors[-1])])
        return recs

    # The sketches' window starts with the controller's traffic (an
    # operator's reset): the load's two-level rows weigh up to 8,192 tokens
    # each, and split_hot_keys ranks by the sketch's totals.
    for s in servers:
        s.heavy_hitters.reset()
    zkeys = [f"cz{i}" for i in range(CLUSTER_ZIPF_KEYS)]
    hot = zkeys[0]
    hot_draws = 0
    split = None
    t = time.perf_counter()
    for n in range(10):
        rows = (rng.zipf(ZIPF_S, CLUSTER_ZIPF_DRAWS) - 1) % CLUSTER_ZIPF_KEYS
        res = await cluster.acquire_many([zkeys[i] for i in rows],
                                         np.ones(len(rows), np.int64),
                                         *CLUSTER_ZIPF_CAP,
                                         with_remaining=False)
        if res.granted_count != len(rows):
            raise AssertionError("controller traffic: a draw was denied")
        hot_draws += int((rows == 0).sum())
        src = cluster.node_index_of(hot)
        recs = await tick()
        done = [r for r in recs if r["action"] == "split"
                and r["outcome"] == "executed"]
        if done:
            split = (n + 1, done[0], src)
            break
    zipf_s = time.perf_counter() - t
    if split is None:
        raise AssertionError(f"controller: no split in 10 ticks {live}")
    tick_n, rec, src = split
    dst = cluster.node_index_of(hot)
    if rec["split_keys"] != [hot] or dst == src or \
            cluster.placement.overrides.get(hot) != dst:
        raise AssertionError(f"controller split: {rec}, {src} -> {dst}")
    cap = CLUSTER_ZIPF_CAP[0]
    want = max(np.float32(0.0), np.float32(cap - hot_draws)
               - np.float32(headroom_budget(cap, fraction=0.5,
                                            min_budget=1.0)))
    got = await asyncio.to_thread(stores[dst].peek_blocking, hot,
                                  *CLUSTER_ZIPF_CAP)
    if np.float32(got) != want:
        raise AssertionError(f"controller split: {hot} holds {got} on node "
                             f"{dst}, oracle {want}")
    # The retry storm: retried reserves only, then calm plain traffic.
    storm_ticks = calm_ticks = 0
    armed_at = released_at = None
    holds = []
    while armed_at is None and storm_ticks < 6:
        storm_ticks += 1
        got = await asyncio.gather(*(cluster.reserve(
            f"storm{storm_ticks}-{i}", f"cst{i % 8}", f"cst{i % 8}/k{i}", 1.0,
            1e6, 10.0, 1000.0, 10.0, attempt=1, ttl_s=3600.0)
            for i in range(CLUSTER_STORM)))
        holds += [(f"storm{storm_ticks}-{i}", f"cst{i % 8}")
                  for i, r in enumerate(got) if r.granted]
        recs = await tick()
        if any(r["action"] == "retry_shed_on" for r in recs):
            armed_at = storm_ticks
    gates = [(s.retry_shed_enabled, s.doomed_gate_enabled) for s in servers]
    if armed_at != cfg.retry_storm_raise_ticks or gates != [(True,
                                                             True)] * 4:
        raise AssertionError(f"storm: armed at storm tick {armed_at}, "
                             f"gates {gates}")
    ckeys = [f"cz{i}" for i in range(1, CLUSTER_ZIPF_KEYS)]
    while released_at is None and calm_ticks < 8:
        calm_ticks += 1
        rows = rng.integers(0, len(ckeys), CLUSTER_CALM)
        await asyncio.gather(*(cluster.acquire(ckeys[i], 1,
                                               *CLUSTER_ZIPF_CAP)
                               for i in rows.tolist()))
        recs = await tick()
        if any(r["action"] == "retry_shed_off" for r in recs):
            released_at = calm_ticks
    if released_at != cfg.retry_storm_lower_ticks or any(
            s.retry_shed_enabled or s.doomed_gate_enabled for s in servers):
        raise AssertionError(f"storm: released at calm tick {released_at}")
    for rid, tn in holds:
        await cluster.settle(rid, tn, 1.0)
    if live != dry or not any(live):
        raise AssertionError(f"dry-run twin: {dry} != {live}")
    # The surfaces: node 0's /metrics and OP_STATS, and an incident bundle
    # carrying the controller's actions (a leak injected as the audit
    # tests inject it).
    status, _, body = await _obs_http(addrs[0][0], servers[0].metrics_port,
                                      "/metrics")
    text = body.decode()
    if f"drl_controller_ticks_total {ctl.ticks}" not in text or \
            'drl_controller_actions_total{action="split"' not in text:
        raise AssertionError("controller: node 0's /metrics lacks the "
                             "drl_controller_* families")
    leak = next(f"cleak{i}" for i in range(1000)
                if cluster.node_index_of(f"cleak{i}") == 0)
    aud = servers[0].auditor
    for _ in range(3):
        aud.tick()
    bundles0 = aud.bundles_assembled
    faults.install(faults.FaultInjector(CLUSTER_SEED, {"audit.leak": (
        faults.FaultRule(kind="error", probability=1.0),)}))
    try:
        for _ in range(10):
            await cluster.acquire(leak, 50, 100.0, CLUSTER_RATE)
    finally:
        faults.uninstall()
    for _ in range(7):
        aud.tick()
        if aud.bundles_assembled > bundles0:
            break
    bundle = aud.bundles[-1] if aud.bundles_assembled > bundles0 else {}
    window = aud.cfg.action_window
    if bundle.get("controller_actions") != list(ctl.actions)[-window:]:
        raise AssertionError("controller: the incident bundle does not "
                             "carry the controller's actions")
    say(f"controller: {len(sensors)} ticks by hand; Zipf({ZIPF_S}) "
        f"{CLUSTER_ZIPF_DRAWS:,} draws a tick over {CLUSTER_ZIPF_KEYS:,} "
        f"keys ({zipf_s:.1f} s); split_hot_keys of {hot} at tick {tick_n} "
        f"(node {src} -> {dst}, {hot_draws:,} draws; its balance on node "
        f"{dst} = the oracle {want:.0f}); retry storm of {CLUSTER_STORM} "
        f"retried reserves a tick armed retry-shed and doomed-work on all "
        f"{len(servers)} servers at storm tick {armed_at}, released at calm "
        f"tick {released_at}; the dry-run twin "
        f"decided the same {sum(map(len, live))} intents; node 0's /metrics "
        "carries drl_controller_*, its incident bundle the controller's "
        f"{len(bundle['controller_actions'])} actions; actions "
        + json.dumps(ctl.stats()["actions_total"]))


async def cluster_path(torch, ck, pkg, card: str) -> dict:
    """The cluster and its controller (phase 19): BASELINE config 2 made a
    three-node fleet. Three ``BucketStoreServer``s, each over a card
    ``DeviceBucketStore`` of 2^24 slots on one frozen ManualClock (the cut:
    the nodes share one card), behind one port ``ClusterBucketStore``
    with breakers on a manual clock, the degraded fallback and ``deny``
    partial failures: the fan-out's load against host oracles, routed
    single-key ops, node 1's outage and rejoin, the scale-out to a fourth
    server with a stale client's MOVED chase, the controller ticked by
    hand, and a sweep of every node. Returns the path's launches."""
    from distributedratelimiting.redis_tpu_torch.runtime import (
        placement as pl,
    )
    from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
        FlightRecorder,
    )
    from distributedratelimiting.redis_tpu_torch.utils.resilience import (
        BreakerConfig,
    )

    t_path = time.perf_counter()
    rng = np.random.default_rng(CLUSTER_SEED)
    ck.reset_launches()

    def say(line: str) -> None:
        print(f"cluster path ({card}) "
              f"[{time.perf_counter() - t_path:.1f} s]: {line}", flush=True)

    clock = pkg.ManualClock(1_000_000)
    stores = [pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                    counter_slots=2**15, clock=clock)
              for _ in range(4)]
    servers = [pkg.BucketStoreServer(s, host="127.0.0.1", port=0,
                                     metrics_port=0 if j == 0 else None)
               for j, s in enumerate(stores)]
    for s in servers:
        # Handoff envelopes and windows on the frozen clock: an envelope
        # refills nothing, so moved balances compare exactly.
        s.placement = pl.NodePlacementState(clock=clock.now_seconds)
    addrs = [await s.start() for s in servers]
    remote_kw = dict(coalesce_requests=False, request_timeout_s=900.0,
                     reconnect_backoff_max_s=0.5)
    bclock = [0.0]
    fr = FlightRecorder(1024)
    cluster = pkg.ClusterBucketStore(
        addresses=addrs[:3],
        breaker=BreakerConfig(failure_threshold=CLUSTER_BREAKER[0],
                              recovery_timeout_s=CLUSTER_BREAKER[1]),
        breaker_clock=lambda: bclock[0], degraded_fallback=True,
        partial_failures="deny", flight_recorder=fr,
        handoff_window_s=900.0, **remote_kw)

    def wire_solo(addr):
        return pkg.RemoteBucketStore(address=addr, coalesce_requests=False,
                                     request_timeout_s=900.0)

    keys = [f"ck{i}" for i in range(CLUSTER_KEYS)]
    oracle = _ClusterOracle(CLUSTER_KEYS, CLUSTER_CAP)
    try:
        # -- 1. the load through the fan-out; a single server's wire bulk
        # beside it (node 3, before it joins, on keys of its own).
        load = await _cluster_load(pkg, cluster, stores, rng, oracle, keys)
        solo = wire_solo(addrs[3])
        skeys = [f"cx{i}" for i in range(CLUSTER_CALL)]
        t = time.perf_counter()
        res = await solo.acquire_many(skeys, np.ones(len(skeys), np.int64),
                                      CLUSTER_CAP, CLUSTER_RATE)
        solo_s = time.perf_counter() - t
        await solo.aclose()
        if res.granted_count != len(skeys):
            raise AssertionError("single-server bulk: a fresh key denied")
        spread = np.bincount(cluster.placement.route(keys), minlength=3)
        say(f"load: {CLUSTER_KEYS:,} bucket keys through the fan-out in "
            f"{CLUSTER_KEYS // CLUSTER_CALL} acquire_many calls of "
            f"{CLUSTER_CALL:,} rows (nodes {spread.tolist()}), "
            f"{CLUSTER_KEYS / load['fan_s']:,.0f} rows/s, beside a single "
            f"server's wire bulk of {CLUSTER_CALL:,} rows at "
            f"{CLUSTER_CALL / solo_s:,.0f} rows/s; {CLUSTER_WINDOW_ROWS:,} "
            f"window asks over {CLUSTER_WINDOW_KEYS:,} windows "
            f"({load['window_denied']:,} denied) = the serial oracle; "
            f"{CLUSTER_COUNTERS:,} counters and {CLUSTER_SEMAS:,} semaphores"
            f" (2 held) in {load['ops_s']:.1f} s; {LLM_ROWS:,} two-level "
            f"LLM rows in {load['hier_s']:.2f} s ({load['hier_denied']:,} "
            f"denied, {load['hier_tokens']:,} tokens; each tenant <= "
            f"{CLUSTER_LLM_BUDGETS[1]:.0f}) = the host's plain versions; "
            f"{CLUSTER_PAIRS} reserve/settle pairs in {load['pairs_s']:.2f}"
            " s; every grant and remaining = the host oracle")
        # -- 2. routed single-key ops.
        await _cluster_singles(cluster, addrs, rng, oracle, keys, wire_solo,
                               say)
        # -- 3. node 1's outage.
        await _cluster_outage(pkg, cluster, stores, servers, addrs, rng,
                              oracle, keys, bclock, fr, remote_kw, say)
        # -- 4. the scale-out and the MOVED chase.
        await _cluster_scale_out(torch, ck, pkg, cluster, stores, addrs,
                                 rng, oracle, keys, remote_kw, say)
        # -- 5. the controller.
        await _cluster_controller(cluster, stores, servers, addrs, rng, say)
        # -- 6. a sweep of every node, two days on.
        live = []
        for s in stores:
            sema = 0
            if s._sema_state is not None:
                active = s._semas.active.cpu().numpy()
                sema = sum(1 for slot in s._sema_dir.to_dict().values()
                           if active[slot] <= 0)
            live.append(sum(len(t.dir) for t in (*s._tables.values(),
                                                 *s._wtables.values()))
                        + len(s._counter_dir) + sema)
        clock.advance_seconds(2 * 86_400.0)
        evicted = []
        t = time.perf_counter()
        for s in stores:
            e0 = s.metrics.slots_evicted
            s.sweep_all()
            evicted.append(s.metrics.slots_evicted - e0)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t
        if evicted != live:
            raise AssertionError(f"cluster sweep: evicted {evicted}, live "
                                 f"{live}")
        say(f"sweep two days on: every node evicted exactly its expired "
            f"slots {evicted} in {sweep_s:.2f} s")
    finally:
        await cluster.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()
    torch.cuda.synchronize()
    counts_out = dict(ck.launches)
    print(f"cluster path ({card}): {time.perf_counter() - t_path:.1f} s "
          "of wall")
    torch.cuda.empty_cache()
    return counts_out


# -- phase 20: global quota federation -----------------------------------------

FED_SEED = 2323
#: Global tenants; ``FED_TENANTS=N`` in the environment sets another count
#: (``FED_TENANTS=128 python3 chip_smoke.py --paths federation``). 64, cut
#: from 256: every slice commit snapshots all its region's tables, one a
#: config, so the commits' seconds grow as the square of the tenants.
FED_TENANTS = int(os.environ.get("FED_TENANTS", "64"))
#: Tenant i's global budget: cap FED_CAP + i tokens, rate
#: (FED_RATE_BASE + i) x FED_RATE_UNIT tokens/s. Like JAX's soak (a
#: pure-burst 600 against the same ask counts), the budget binds: a
#: tenant's ~150 asks over the rounds exceed its cap, so its slices, r2's
#: envelope and the global bound deny asks. The rates are distinct, so no
#: two tenants share a slice config (a commit rebases a config's whole
#: table), and small, so rate x elapsed adds under a tenant's one token.
FED_CAP = 60.0
FED_RATE_BASE, FED_RATE_UNIT = 100.0, 1e-4
FED_ROUNDS = 26                 # the soak's rounds, one second each
FED_PARTITION_AT, FED_RESTART_AT, FED_HEAL_AT = 8, 14, 20
FED_TTL = 6.0
FED_RENEW_FRACTION = 0.5
#: Initial slots of every table of the path's stores (tables grow by
#: doubling). A card store keeps one dense table per (cap, rate) config,
#: and federation gives every tenant's global budget, slice and envelope a
#: config of its own: at 2^24 slots a table (144 MB) the home alone would
#: hold 256 tables, 37 GB, and every snapshot would read them all.
FED_SLOTS = 2**12
FED_CTL_TICKS = 6               # controller ticks, the actuator every 3
FED_CTL_RENEW = 3
FED_STALL_KEYS = 1_000_000      # r0's ordinary per-user keys
FED_STALL_CALL = 250_000
FED_STALL_CFG = (100.0, 1.0)
FED_PROBE_SLOTS = 2**24         # the one commit on a full-size table
#: Relative tolerance of a token field of a home reply against the host
#: replay (a float32 debit stands between): of the field, and of a debt
#: (an amount less a float32 balance, so off by the balance's rounding)
#: of the tenant's cap, the scale of the balance it came from.
FED_RTOL = 1e-6


def _fed_tenants() -> dict:
    return {f"fed:t{i}": (FED_CAP + i, (FED_RATE_BASE + i) * FED_RATE_UNIT)
            for i in range(FED_TENANTS)}


def _fed_chaos(faults) -> dict:
    """The soak's chaos on the federation seams (JAX
    ``tests/test_federation.py:600-617``): delays, injected errors and
    resets on the WAN calls, delays at the home's dispatch."""
    R = faults.FaultRule
    return {
        "federation.renew": (R(kind=faults.DELAY, probability=0.2,
                               delay_s=0.001),
                             R(kind=faults.ERROR, probability=0.08),
                             R(kind=faults.RESET, probability=0.05)),
        "federation.lease": (R(kind=faults.DELAY, probability=0.2,
                               delay_s=0.001),
                             R(kind=faults.ERROR, probability=0.1)),
        "server.federation": (R(kind=faults.DELAY, probability=0.1,
                                delay_s=0.001),),
    }


def _fed_same(got, want, where: str, cap: float,
              scale: float = 1.0) -> None:
    """A home reply against the replay's: ids, epochs, outcomes and flags
    exactly; token fields within :data:`FED_RTOL` relative (a debt's of
    ``cap``, the tenant's)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{where}: fields {got!r} != {want!r}")
        for k in want:
            _fed_same(got[k], want[k], f"{where}.{k}", cap,
                      cap if k == "debt" else 1.0)
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{where}: {got!r} != {want!r}")
        for i, (g, w) in enumerate(zip(got, want)):
            _fed_same(g, w, f"{where}[{i}]", cap)
    elif isinstance(want, float) or isinstance(got, float):
        if isinstance(got, bool) or isinstance(want, bool) or abs(
                float(got) - float(want)) > FED_RTOL * max(1.0, abs(want),
                                                           scale):
            raise AssertionError(f"{where}: {got!r} != {want!r}")
    elif got != want:
        raise AssertionError(f"{where}: {got!r} != {want!r}")


class _FedTape:
    """Every home ledger call, in order, with the home clock's reading and
    the reply: the host replay's input."""

    def __init__(self, mono) -> None:
        self.mono = mono
        self.calls: list = []

    def wrap(self, led) -> None:
        for op in ("lease", "renew", "reclaim"):
            real = getattr(led, op)

            async def recorded(req, _real=real, _op=op):
                at = self.mono[0]
                out = await _real(req)
                self.calls.append((_op, json.loads(json.dumps(req)), at,
                                   json.loads(json.dumps(out))))
                return out

            setattr(led, op, recorded)

    def restart(self) -> None:
        self.calls.append(("restart", None, self.mono[0], None))


async def _fed_replay(pkg, tape: _FedTape) -> tuple:
    """The host replay: the tape's requests, in order and at the recorded
    home clock readings, to a port ``FederationLedger`` over an
    ``InProcessBucketStore``; the restart re-anchors its state as the
    chain does. Every reply must equal the card home's. Returns the calls
    replayed, the replay store's global tenant balances ``{(key, cap,
    rate): tokens}`` and the debits each key took."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    mono = [0.0]
    debits: collections.Counter = collections.Counter()

    def fresh():
        st = pkg.InProcessBucketStore(clock=pkg.ManualClock(1_000_000))
        led = st.federation_ledger(clock=lambda: mono[0],
                                   default_ttl_s=FED_TTL)
        real = st.debit_many

        async def counted(keys, amounts, cap, rate):
            debits.update(keys)
            return await real(keys, amounts, cap, rate)

        st.debit_many = counted
        return st, led

    store, led = fresh()
    caps = {t: cap for t, (cap, _rate) in _fed_tenants().items()}
    n = 0
    for i, (op, req, at, want) in enumerate(tape.calls):
        mono[0] = at
        if op == "restart":
            snap = checkpoint._snapshot_with_attachments(store)
            await store.aclose()
            store, led = fresh()
            checkpoint._restore_with_attachments(store, snap)
            continue
        got = await getattr(led, op)(req)
        _fed_same(json.loads(json.dumps(got)), want,
                  f"home reply {i} ({op} {req.get('lease_id')})",
                  caps[req["tenant"]])
        n += 1
    balances = _fed_balances(store)
    await store.aclose()
    return n, balances, debits


def _fed_balances(store) -> dict:
    """A store's tenant buckets ``{(key, cap, rate): tokens}``, read
    through its export."""
    return {(key, float(cap), float(rate)): float(tokens)
            for key, cap, rate, tokens, _age in store.export_entries(
                lambda k: k.startswith("fed:t"))["buckets"]}


class _FedOracle:
    """One region's float32 host oracle: each tenant key's balance in every
    config table it touched, following the region's applied config
    history (a commit carries ``cap_old - tokens`` into the new table
    through the saturating debit, as the rebase does; the clock is frozen,
    so nothing refills)."""

    def __init__(self) -> None:
        self.tokens: dict = {}          # (tenant, cap, rate) -> f32
        self.applied: dict = {}         # tenant -> (cap, rate)

    def apply(self, tenant, old, new) -> None:
        if old is not None and tuple(old) != tuple(new):
            was = self.tokens.get((tenant, *old))
            spent = 0.0 if was is None else float(old[0]) - float(was)
            if spent > 0.0:
                base = self.tokens.get((tenant, *new), np.float32(new[0]))
                self.tokens[(tenant, *new)] = max(
                    np.float32(0.0), np.float32(base) - np.float32(spent))
        self.applied[tenant] = tuple(new)

    def ask(self, tenant, n: int) -> int:
        cfg = self.applied[tenant]
        tok = self.tokens.get((tenant, *cfg), np.float32(cfg[0]))
        granted = 0
        for _ in range(n):
            if tok >= np.float32(1.0):
                tok = np.float32(tok - np.float32(1.0))
                granted += 1
        self.tokens[(tenant, *cfg)] = tok
        return granted


class _FedRegion:
    """One region of the federation path: its card store(s) and server(s),
    a traffic client that always sends the first slice's operands (every
    later change is an ``OP_CONFIG`` rule it chases), the agent, and the
    oracle."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.mono = [0.0]
        self.stores: list = []
        self.servers: list = []
        self.client = None
        self.target = None
        self.agent = None
        self.oracle = _FedOracle()
        #: The schedule's demand, the agent's own report when a
        #: controller's tick brings no tenant rates.
        self.demand = 4.0
        self.first: dict = {}
        self.admitted: dict = {}
        self.denied: dict = {}
        self.partition_admits: dict = {}
        self.partition_denied = 0
        #: Slice applications that raised. The agent absorbs such a failure
        #: (it keeps the old config and counts it among its renew
        #: failures, beside the chaos's injected ones), so the path counts
        #: them here and fails on any.
        self.apply_failures: list = []
        self.commits: list = []         # seconds of each slice commit
        self.renews: list = []          # seconds of each renew round trip

    async def start(self, pkg, fed, clock, home_client, tenants) -> None:
        n = 2 if self.name == "r1" else 1
        self.stores = [pkg.DeviceBucketStore(device="cuda", n_slots=FED_SLOTS,
                                             clock=clock) for _ in range(n)]
        self.servers = [pkg.BucketStoreServer(s, host="127.0.0.1", port=0)
                        for s in self.stores]
        addrs = [await s.start() for s in self.servers]
        kw = dict(coalesce_requests=False, request_timeout_s=900.0)
        if n == 2:
            # r1 is a two-server cluster: slices apply through
            # mutate_config, two-phase over both nodes.
            self.client = pkg.ClusterBucketStore(addresses=addrs, **kw)
            self.target = pkg.ClusterBucketStore(addresses=addrs, **kw)
        else:
            # r0 and r2 are single servers: slices apply through
            # config_announce (prepare, then commit at the next version).
            self.client = pkg.RemoteBucketStore(address=addrs[0], **kw)
            self.target = pkg.RemoteBucketStore(address=addrs[0], **kw)
        inner = fed.slice_applier(self.target)

        async def apply(tenant, old, new):
            t = time.perf_counter()
            try:
                await inner(tenant, old, new)
            except Exception as exc:
                self.apply_failures.append(f"{tenant} {old} -> {new}: "
                                           f"{exc!r}")
                raise
            if old is not None and tuple(old) != tuple(new):
                self.commits.append(time.perf_counter() - t)
            self.oracle.apply(tenant, old, new)

        self.agent = fed.RegionFederation(
            self.name, home_client, tenants=tenants, apply_slice=apply,
            admitted_total=lambda t: float(self.admitted.get(t, 0)),
            demand=lambda _t: self.demand,
            ttl_s=FED_TTL, renew_fraction=FED_RENEW_FRACTION,
            clock=lambda: self.mono[0])
        real_call = self.agent._call_home

        async def timed(method, payload):
            t = time.perf_counter()
            out = await real_call(method, payload)
            if method == "fed_renew":
                self.renews.append(time.perf_counter() - t)
            return out

        self.agent._call_home = timed
        self.servers[0].federation_agent = self.agent

    async def drive(self, counts, tenants: list, partitioned: bool) -> None:
        """``counts[j]`` unit asks for tenant ``j``, all sent at once under
        the tenant's first slice; every tenant's grants equal the
        oracle's."""
        asks, who = [], []
        for j, n in enumerate(counts.tolist()):
            t = tenants[j]
            cfg = self.agent.slice(t)
            if cfg is None or n == 0:
                continue
            first = self.first.setdefault(t, cfg)
            asks += [self.client.acquire(t, 1, *first) for _ in range(n)]
            who += [t] * n
        res = await asyncio.gather(*asks)
        got: dict = {}
        for t, r in zip(who, res):
            got[t] = got.get(t, 0) + int(r.granted)
        for t, n in collections.Counter(who).items():
            want = self.oracle.ask(t, n)
            if got.get(t, 0) != want:
                raise AssertionError(
                    f"federation {self.name}: {t} granted {got.get(t, 0)}, "
                    f"the oracle {want}")
            self.admitted[t] = self.admitted.get(t, 0) + want
            self.denied[t] = self.denied.get(t, 0) + n - want
            if partitioned:
                self.partition_admits[t] = \
                    self.partition_admits.get(t, 0) + want
                self.partition_denied += n - want

    def balances(self) -> dict:
        """Every tenant key's balance in every table, read from the card
        stores' export."""
        out: dict = {}
        for s in self.stores:
            for key, cap, rate, tokens, _age in s.export_entries(
                    lambda k: k.startswith("fed:t"))["buckets"]:
                if (key, cap, rate) in out:
                    raise AssertionError(f"federation {self.name}: {key} "
                                         "on two nodes")
                out[(key, float(cap), float(rate))] = np.float32(tokens)
        return out

    async def aclose(self) -> None:
        for c in (self.client, self.target):
            if c is not None:
                await c.aclose()
        for s in self.servers:
            await s.aclose()
        for s in self.stores:
            await s.aclose()


class _FedQuiet(logging.Filter):
    """The federation path's log filter: drops, and counts by kind, the
    records of what the path injects on purpose (the chaos rules' errors
    and resets, the partition's resets) and r1's routine config-commit
    lines; every other record passes."""

    def __init__(self, faults) -> None:
        super().__init__()
        self._injected = faults.FaultInjectedError
        self.dropped: collections.Counter = collections.Counter()

    def filter(self, record) -> bool:
        exc = record.exc_info[1] if record.exc_info else None
        if isinstance(exc, self._injected):
            kind = "injected error"
        elif isinstance(exc, ConnectionResetError) and (
                str(exc) == "partitioned" or str(exc).startswith("injected")):
            kind = "reset"
        elif str(getattr(record, "migration", {}).get("type", "")
                 ).startswith("config"):
            kind = "r1 commit"
        else:
            return True
        self.dropped[kind] += 1
        return False


class _FedDownHome:
    """The full partition: every WAN call from the region dies."""

    async def fed_lease(self, _payload, **_kw):
        raise ConnectionResetError("partitioned")

    fed_renew = fed_lease
    fed_reclaim = fed_lease


async def _fed_probe(pkg, fed, clock, say) -> float:
    """One slice commit on a card store of 2^24 slots a table, the store
    holding one tenant key: the rebase snapshots the whole store."""
    store = pkg.DeviceBucketStore(device="cuda", n_slots=FED_PROBE_SLOTS,
                                  clock=clock)
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0)
    addr = await server.start()
    cli = pkg.RemoteBucketStore(address=addr, coalesce_requests=False,
                                request_timeout_s=900.0)
    try:
        old, new = (10_000.0, 100.0), (5_000.0, 50.0)
        if not (await cli.acquire("fed:probe", 3, *old)).granted:
            raise AssertionError("federation probe: the ask was denied")
        t = time.perf_counter()
        await fed.slice_applier(cli)("fed:probe", old, new)
        commit_s = time.perf_counter() - t
        got = store.peek_blocking("fed:probe", *new)
        if got != new[0] - 3:
            raise AssertionError(f"federation probe: {got} after the commit")
    finally:
        await cli.aclose()
        await server.aclose()
        await store.aclose()
    say(f"one slice commit on a card store of {FED_PROBE_SLOTS:,} slots a "
        f"table (one tenant key, 144 MB a table): {commit_s:.3f} s")
    return commit_s


async def _fed_stall(ck, reg, tenant_cfg: dict, say) -> dict:
    """The real-size stall: r0 holds 1M ordinary bucket keys beside its
    tenant buckets; one tenant's resize forced through a renew commits on
    that store while another tenant asks."""
    keys = [f"fu{i}" for i in range(FED_STALL_KEYS)]
    t = time.perf_counter()
    for pos in range(0, FED_STALL_KEYS, FED_STALL_CALL):
        res = await reg.client.acquire_many(
            keys[pos:pos + FED_STALL_CALL],
            np.ones(min(FED_STALL_CALL, FED_STALL_KEYS - pos), np.int64),
            *FED_STALL_CFG, with_remaining=False)
        if res.granted_count != min(FED_STALL_CALL, FED_STALL_KEYS - pos):
            raise AssertionError("federation stall: a fresh key was denied")
    load_s = time.perf_counter() - t
    store = reg.stores[0]
    timer = store._lock = _HoldTimer(store._lock)
    resized, other = list(tenant_cfg)[:2]
    lease = reg.agent._leases[resized]
    # A share far above the floor shrinks to it; one near it grows.
    share = lease.slice_cap / tenant_cfg[resized][0]
    demand = 1e-3 if share > 0.1 else 1e9
    epoch, commits0 = lease.epoch, len(reg.commits)
    first = reg.first.setdefault(other, reg.agent.slice(other))
    lat = []
    done = asyncio.Event()

    async def asks():
        while True:
            t = time.perf_counter()
            r = await reg.client.acquire(other, 1, *first)
            lat.append(time.perf_counter() - t)
            if int(r.granted) != reg.oracle.ask(other, 1):
                raise AssertionError("federation stall: an ask differs "
                                     "from the oracle")
            reg.admitted[other] = reg.admitted.get(other, 0) + int(r.granted)
            if done.is_set():
                return

    task = asyncio.ensure_future(asks())
    launch_before = dict(ck.launches)
    try:
        t = time.perf_counter()
        ok, _ = await reg.agent._renew(resized, lease, demand, reg.mono[0])
        renew_s = time.perf_counter() - t
    finally:
        done.set()
        await task
    if not ok or lease.epoch == epoch or len(reg.commits) != commits0 + 1:
        raise AssertionError(f"federation stall: the renew did not resize "
                             f"{resized} (ok {ok}, epoch {epoch} -> "
                             f"{lease.epoch})")
    commit_s = reg.commits[-1]
    launches = {k: v - launch_before.get(k, 0) for k, v in ck.launches.items()
                if v > launch_before.get(k, 0)}
    say(f"the stall: r0 loaded with {FED_STALL_KEYS:,} bucket keys at "
        f"{FED_STALL_CFG} in {load_s:.1f} s; {resized}'s resize forced "
        f"through a renew: the renew {renew_s:.2f} s, its slice commit "
        f"{commit_s:.2f} s, the store lock's longest hold "
        f"{timer.longest:.2f} s; {len(lat)} asks on {other} meanwhile, the "
        f"longest {max(lat):.2f} s (the serving stall); launches "
        f"{json.dumps(launches)}")
    store._lock = timer._lock
    return {"commit_s": commit_s, "lock_s": timer.longest,
            "ask_max_s": max(lat), "renew_s": renew_s}


async def _fed_controller(pkg, ctl_mod, regions: dict, home_mono,
                          say) -> None:
    """A ``Controller`` with ``federation=`` r0's agent, over r0's server's
    own stats, ticked by hand with every clock a second on between ticks
    (r1 and r2 tick themselves): the actuator fires at its cadence, and a
    dry-run twin fed the same ``Sensors`` decides the same intents."""
    import types

    r0 = regions["r0"]
    scraper = pkg.RemoteBucketStore(address=(r0.servers[0].host,
                                             r0.servers[0].port),
                                    coalesce_requests=False)

    async def stats():
        return {"nodes": [await scraper.stats()], "resilience": {},
                "placement": {}}

    cfg = dict(federation_renew_ticks=FED_CTL_RENEW, cooldown_ticks=0)
    ctl = ctl_mod.Controller(types.SimpleNamespace(stats=stats),
                             config=ctl_mod.ControllerConfig(**cfg),
                             federation=r0.agent)
    twin = ctl_mod.Controller(types.SimpleNamespace(), config=(
        ctl_mod.ControllerConfig(**cfg, dry_run=True)), federation=r0.agent)
    scrape = ctl.scrape
    sensors = []

    async def recorded():
        s = await scrape()
        sensors.append(s)
        return s

    ctl.scrape = recorded
    live, dry, fired = [], [], []
    renews0 = r0.agent.renews
    try:
        for n in range(1, FED_CTL_TICKS + 1):
            home_mono[0] += 1.0
            for reg in regions.values():
                reg.mono[0] += 1.0
            for name in ("r1", "r2"):
                await regions[name].agent.tick()
            recs = await ctl.tick()
            twin._tick = sensors[-1].tick
            live.append([(r["action"], r["target"], r["reason"])
                         for r in recs])
            dry.append([(i["action"], i["target"], i["reason"])
                        for i in twin.decide(sensors[-1])])
            fired += [(n, r["outcome"], r["reason"]) for r in recs
                      if r["action"] == "federation"]
    finally:
        await scraper.aclose()
    # The actuator fires at its cadence, and off it only on the degraded
    # rung (a slice serving its envelope two ticks running).
    cadence = [n for n, _, why in fired if why.startswith("renew cadence")]
    off = [why for n, _, why in fired if n % FED_CTL_RENEW]
    if cadence != list(range(FED_CTL_RENEW, FED_CTL_TICKS + 1,
                             FED_CTL_RENEW)) or \
            any(o != "executed" for _, o, _ in fired) or \
            any("degraded" not in why for why in off):
        raise AssertionError(f"federation controller: fired {fired}")
    if live != dry:
        raise AssertionError(f"federation dry-run twin: {dry} != {live}")
    if r0.agent.renews <= renews0:
        raise AssertionError("federation controller: the actuator renewed "
                             "nothing")
    say(f"controller: {FED_CTL_TICKS} ticks by hand, the federation "
        f"actuator at ticks {[n for n, _, _ in fired]} (every "
        f"{FED_CTL_RENEW}), {r0.agent.renews - renews0} renews through it; "
        f"the dry-run twin decided the same {sum(map(len, live))} intents")


async def federation_path(torch, ck, pkg, card: str) -> dict:
    """Global quota federation (phase 20): JAX's 3-region soak
    (``tests/test_federation.py:596-900``) on the card. A home
    ``BucketStoreServer`` over a card store with a ``FederationLedger`` and
    a ``SnapshotChain``; regions r0 and r2 single servers over card stores
    (slices through ``config_announce``), r1 a two-server
    ``ClusterBucketStore`` (slices through ``mutate_config``); all on one
    frozen store clock, the leases on manual monotonic clocks a second a
    round. :data:`FED_TENANTS` global tenants on budgets that bind; the
    soak's chaos, partition, home restart and heal; every slice applied,
    every home reply and global bucket held to a host replay, every grant
    and balance to a float32 oracle; the controller's actuator; the
    1M-key commit stall; a sweep. Returns the path's launches."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint
    from distributedratelimiting.redis_tpu_torch.runtime import (
        controller as ctl_mod,
    )
    from distributedratelimiting.redis_tpu_torch.runtime import (
        federation as fed,
    )
    from distributedratelimiting.redis_tpu_torch.utils import faults
    import tempfile

    t_path = time.perf_counter()
    rng = np.random.default_rng(FED_SEED)
    ck.reset_launches()

    def say(line: str) -> None:
        print(f"federation path ({card}) "
              f"[{time.perf_counter() - t_path:.1f} s]: {line}", flush=True)

    clock = pkg.ManualClock(1_000_000)
    probe_s = await _fed_probe(pkg, fed, clock, say)
    tenant_cfg = _fed_tenants()
    tenants = list(tenant_cfg)
    counts = rng.integers(0, 5, (FED_ROUNDS, 3, FED_TENANTS))
    counts[FED_HEAL_AT:, 2] = rng.integers(
        0, 3, (FED_ROUNDS - FED_HEAL_AT, FED_TENANTS))
    tmp = tempfile.mkdtemp(prefix="drl-fed-")
    chain_path = os.path.join(tmp, "home.ckpt")
    chain = checkpoint.SnapshotChain(chain_path)
    home_mono = [0.0]
    tape = _FedTape(home_mono)

    def home_store():
        st = pkg.DeviceBucketStore(device="cuda", n_slots=FED_SLOTS,
                                   clock=clock)
        st.federation_ledger(clock=lambda: home_mono[0],
                             default_ttl_s=FED_TTL)
        return st

    home = home_store()
    tape.wrap(home._federation)
    home_srv = pkg.BucketStoreServer(home, host="127.0.0.1", port=0,
                                     metrics_port=0)
    home_addr = await home_srv.start()

    def home_client():
        return pkg.RemoteBucketStore(address=home_addr,
                                     coalesce_requests=False,
                                     request_timeout_s=900.0)

    regions = {n: _FedRegion(n) for n in ("r0", "r1", "r2")}
    clients = {n: home_client() for n in regions}
    faults.install(faults.FaultInjector(FED_SEED, _fed_chaos(faults)))
    # The chaos's injected faults log a traceback each, and every commit of
    # r1's cluster a line: thousands. The filter drops those alone.
    pkg_log = logging.getLogger("distributedratelimiting.redis_tpu_torch")
    quiet = _FedQuiet(faults)
    pkg_log.addFilter(quiet)
    events = []
    slice_at_partition: dict = {}
    ids_before: set = set()
    try:
        for n, reg in regions.items():
            await reg.start(pkg, fed, clock, clients[n], tenant_cfg)
        t_rounds = time.perf_counter()
        tick_s = drive_s = 0.0
        for rnd in range(FED_ROUNDS):
            home_mono[0] += 1.0
            for reg in regions.values():
                reg.mono[0] += 1.0
            if rnd == FED_PARTITION_AT:
                r2 = regions["r2"]
                r2.agent.home = _FedDownHome()
                slice_at_partition = {t: r2.agent.slice(t) for t in tenants
                                      if r2.agent.slice(t) is not None}
                ids_before = {r2.agent._leases[t].lease_id for t in tenants}
                ids_before.discard(None)
                events.append(f"partition:r2@{rnd}")
            if rnd == FED_RESTART_AT:
                led = home._federation
                before = {(t, r): l.expires_mono - home_mono[0]
                          for t, p in led._pools.items()
                          for r, l in p.leases.items()}
                t = time.perf_counter()
                chain.save(home)
                save_s = time.perf_counter() - t
                await home_srv.aclose()
                for c in clients.values():
                    await c.aclose()
                await home.aclose()
                tape.restart()
                home = home_store()
                t = time.perf_counter()
                links = checkpoint.load_snapshot_chain(home, chain_path)
                load_s = time.perf_counter() - t
                led = home._federation
                tape.wrap(led)
                after = {(t, r): l.expires_mono - home_mono[0]
                         for t, p in led._pools.items()
                         for r, l in p.leases.items()}
                if led.restores != 1 or set(after) != set(before) or any(
                        after[k] > before[k] for k in after):
                    raise AssertionError(
                        f"federation restart: restores {led.restores}, "
                        f"{len(after)} leases against {len(before)}, or a "
                        "term extended")
                home_srv = pkg.BucketStoreServer(home, host="127.0.0.1",
                                                 port=0, metrics_port=0)
                home_addr = await home_srv.start()
                for n, reg in regions.items():
                    clients[n] = home_client()
                    if n != "r2":
                        reg.agent.home = clients[n]
                dups = 0
                for t in tenants:
                    held = regions["r0"].agent._leases[t].lease_id
                    if held is None:
                        continue
                    r = await clients["r0"].fed_lease({
                        "region": "r0", "lease_id": held, "tenant": t,
                        "demand": 8.0, "global_cap": tenant_cfg[t][0],
                        "global_rate": tenant_cfg[t][1]})
                    if not r.get("duplicate"):
                        raise AssertionError(f"federation restart: a WAN "
                                             f"retry of {held}: {r}")
                    dups += 1
                events.append(f"restart@{rnd}")
                say(f"home restart at round {rnd}: the chain's save "
                    f"{save_s:.3f} s, its load {load_s:.3f} s ({links} delta "
                    f"links), {len(after)} leases restored, none extended; "
                    f"{dups} WAN retries of r0's leases answered duplicate")
            if rnd == FED_HEAL_AT:
                regions["r2"].agent.home = clients["r2"]
                events.append(f"heal:r2@{rnd}")
            demands = {"r0": 8.0 if rnd >= 4 else 4.0,
                       "r1": 2.0 if rnd >= 4 else 4.0, "r2": 4.0}
            for j, (n, reg) in enumerate(regions.items()):
                reg.demand = demands[n]
                t = time.perf_counter()
                summary = await reg.agent.tick()
                tick_s += time.perf_counter() - t
                if summary["degraded"]:
                    events.append(f"degraded:{n}@{rnd}x{summary['degraded']}")
                if summary["healed"]:
                    events.append(f"healed:{n}@{rnd}x{summary['healed']}")
                t = time.perf_counter()
                await reg.drive(counts[rnd, j], tenants,
                                n == "r2" and FED_PARTITION_AT <= rnd
                                < FED_HEAL_AT)
                drive_s += time.perf_counter() - t
            if rnd % 4 == 1:
                chain.save(home)
        rounds_s = time.perf_counter() - t_rounds
        say(f"{FED_ROUNDS} rounds of {FED_TENANTS} tenants x 3 regions in "
            f"{rounds_s:.1f} s (agent ticks {tick_s:.1f} s, asks "
            f"{drive_s:.1f} s); events {events}")
        await _fed_controller(pkg, ctl_mod, regions, home_mono, say)
        stall = await _fed_stall(ck, regions["r0"], tenant_cfg, say)
        # The surfaces while the leases are held: the home's /metrics, a
        # region server's (its federation_agent set).
        status, _, body = await _obs_http(home_addr[0],
                                          home_srv.metrics_port, "/metrics")
        text = body.decode()
        region_text = await regions["r0"].client.metrics()
        shares = text.count("drl_federation_slice_share{")
        if "drl_federation_leases_granted_total" not in text or \
                shares == 0 or \
                "drl_federation_region_renews_total" not in region_text:
            raise AssertionError(f"federation: /metrics lacks the "
                                 f"drl_federation_* families ({status})")
        # Every slice change applied: no application raised, and every
        # lease that is not degraded serves its slice.
        failures = [f for reg in regions.values() for f in reg.apply_failures]
        stale = [(reg.name, t, l.applied, (l.slice_cap, l.slice_rate))
                 for reg in regions.values()
                 for t, l in reg.agent._leases.items()
                 if l.lease_id is not None and not l.degraded
                 and l.applied != (l.slice_cap, l.slice_rate)]
        if failures or stale:
            raise AssertionError(f"federation: {len(failures)} slice "
                                 f"applications failed {failures[:3]}; "
                                 f"leases not on their slice {stale[:3]}")
        r2 = regions["r2"]
        fresh = {r2.agent._leases[t].lease_id for t in tenants}
        for reg in regions.values():
            await reg.agent.reclaim_all()
        led = home._federation
        held_after = [(reg.name, t) for reg in regions.values()
                      for t, l in reg.agent._leases.items()
                      if l.lease_id is not None]
        if held_after or led.outstanding_leases():
            raise AssertionError(f"federation reclaim: {held_after[:3]} "
                                 f"held, {led.outstanding_leases()} at the "
                                 "home")

        # -- the checks.
        held = len(slice_at_partition)
        if r2.agent.degraded_entries < held:
            raise AssertionError(f"federation: r2 degraded "
                                 f"{r2.agent.degraded_entries} of {held} "
                                 f"slices {events}")
        if None in fresh or r2.agent.heals < held or led.heals < 1 or \
                led.refunded_tokens <= 0.0:
            raise AssertionError(f"federation heal: agent heals "
                                 f"{r2.agent.heals}, home heals {led.heals}, "
                                 f"refunded {led.refunded_tokens}")
        if fresh & ids_before:
            raise AssertionError("federation heal: a lease id was reused")
        eps_window = (FED_ROUNDS + FED_CTL_TICKS) * 1.0
        worst = []
        for t in tenants:
            cap, rate = tenant_cfg[t]
            # The soak's ε: r2's envelope twice (its burst and the heal's
            # re-mint) and federation_epsilon over r2's slice at the
            # partition; a tenant r2 held no slice of then, the staleness
            # term over the whole budget.
            sl = slice_at_partition.get(t)
            env = fed.degraded_config(*sl)[0] if sl else 0.0
            eps = 2 * env + fed.federation_epsilon(
                3, *(sl or (cap, rate)), FED_TTL * FED_RENEW_FRACTION,
                partition_s=float(FED_HEAL_AT - FED_PARTITION_AT) if sl
                else 0.0)
            total = sum(reg.admitted.get(t, 0) for reg in regions.values())
            if total > cap + rate * eps_window + eps:
                raise AssertionError(f"federation bound: {t} admitted "
                                     f"{total}")
            part = r2.partition_admits.get(t, 0)
            if part > 2 * env:
                raise AssertionError(f"federation partition: {t} admitted "
                                     f"{part} > 2 x {env}")
            worst.append(total / (cap + rate * eps_window + eps))
        for reg in regions.values():
            got = reg.balances()
            want = reg.oracle.tokens
            if got != want:
                diff = [k for k in set(got) | set(want)
                        if got.get(k) != want.get(k)][:5]
                raise AssertionError(f"federation {reg.name}: balances "
                                     f"differ from the oracle at {diff}")
        denied = sum(sum(reg.denied.values()) for reg in regions.values())
        if denied == 0 or r2.partition_denied == 0:
            raise AssertionError(f"federation: the budgets bound no ask "
                                 f"(denied {denied}, in r2's partition "
                                 f"{r2.partition_denied})")
        t = time.perf_counter()
        replayed, replay_bal, debits = await _fed_replay(pkg, tape)
        replay_s = time.perf_counter() - t
        # The home's card store: every global tenant bucket equal to the
        # replay store's, and (JAX's soak, check 2) its spend plus the
        # debts equal to what the regions admitted. Tolerance: the card
        # debits in float32, one rounding of the amount and one of the
        # balance a debit, so one float32 spacing of the cap a debit.
        home_bal = _fed_balances(home)
        one_side = sorted(set(home_bal) ^ set(replay_bal))
        if one_side:
            raise AssertionError(f"federation home: buckets {one_side[:3]} "
                                 "on one side only")
        debts = led.debts()
        for t in tenants:
            cap, rate = tenant_cfg[t]
            tol = max(1, debits[t]) * float(np.spacing(np.float32(cap)))
            got = home_bal.get((t, cap, rate), cap)
            want = replay_bal.get((t, cap, rate), cap)
            owed = sum(v for (tt, _r), v in debts.items() if tt == t)
            admitted = sum(reg.admitted.get(t, 0)
                           for reg in regions.values())
            if abs(got - want) > tol or \
                    abs(cap - got + owed - admitted) > tol:
                raise AssertionError(
                    f"federation home: {t} holds {got} (replay {want}, "
                    f"{debits[t]} debits), spent {cap - got} + debt {owed} "
                    f"against {admitted} admitted")
        audit = home_srv.auditor.tick()
        res = audit["residues"]
        if "federation" in audit["breaches"] or "federation" not in res:
            raise AssertionError(f"federation audit: {res}")
        renews = [x for reg in regions.values() for x in reg.renews]
        commits = [x for reg in regions.values() for x in reg.commits]
        n_bal = sum(len(r.oracle.tokens) for r in regions.values())
        by_region = {r.name: sum(r.denied.values()) for r in regions.values()}
        say(f"every home reply ({replayed:,}) = the host replay "
            f"({replay_s:.1f} s), and the home's {len(home_bal)} global "
            f"buckets = the replay's, spend + debt = admitted; every grant "
            f"and {n_bal:,} tenant balances = the float32 oracle; asks "
            f"denied {json.dumps(by_region)}"
            f" ({r2.partition_denied} in r2's partition); Σ admits <= cap + "
            f"rate x {eps_window:.0f} s + ε for every tenant (at most "
            f"{max(worst):.3f} of it); r2's partition admits <= 2 x its "
            f"envelope; {led.heals} heals, refunded "
            f"{led.refunded_tokens:,.1f} tokens, fresh lease ids; no slice "
            f"application failed; log records dropped "
            f"{json.dumps(dict(quiet.dropped))}; the "
            f"home's audit clean (federation residue "
            f"{res['federation']:,.1f}); /metrics renders "
            f"drl_federation_* and {shares} drl_federation_slice_share "
            "samples, r0's drl_federation_region_*")
        say(f"renews {len(renews):,}: {len(renews) / sum(renews):,.0f}/s "
            f"one at a time, p50 {_pct(renews, 50) * 1e3:.2f} ms, p99 "
            f"{_pct(renews, 99) * 1e3:.2f} ms; slice commits "
            f"{len(commits):,}: p50 {_pct(commits, 50) * 1e3:.1f} ms, max "
            f"{max(commits) * 1e3:.1f} ms, {sum(commits):.1f} s in all; the "
            f"{FED_STALL_KEYS:,}-key stall {stall['commit_s']:.2f} s; the "
            f"{FED_PROBE_SLOTS:,}-slot probe "
            f"{probe_s:.3f} s; ledger {json.dumps(led.numeric_stats())}")

        # -- the sweep, two days on.
        stores = [home] + [s for reg in regions.values() for s in reg.stores]
        live = [sum(len(tb.dir) for tb in (*s._tables.values(),
                                           *s._wtables.values()))
                + len(s._counter_dir) for s in stores]
        clock.advance_seconds(2 * 86_400.0)
        evicted = []
        for s in stores:
            e0 = s.metrics.slots_evicted
            s.sweep_all()
            evicted.append(s.metrics.slots_evicted - e0)
        torch.cuda.synchronize()
        if evicted != live:
            raise AssertionError(f"federation sweep: evicted {evicted}, live "
                                 f"{live}")
        say(f"sweep two days on: every store evicted exactly its expired "
            f"slots {evicted}")
    finally:
        faults.uninstall()
        pkg_log.removeFilter(quiet)
        for reg in regions.values():
            await reg.aclose()
        for c in clients.values():
            await c.aclose()
        await home_srv.aclose()
        await home.aclose()
    torch.cuda.synchronize()
    counts_out = dict(ck.launches)
    print(f"federation path ({card}): launches debit_packed "
          f"{counts_out.get('debit_packed', 0)}, acquire_packed "
          f"{counts_out.get('acquire_packed', 0)}, acquire_grouped "
          f"{counts_out.get('acquire_grouped', 0)}; "
          f"{time.perf_counter() - t_path:.1f} s of wall")
    torch.cuda.empty_cache()
    return counts_out


SIZED_KERNELS = {"acquire_packed": "acquire_packed",
                 "acquire_grouped": "acquire_grouped",
                 "window_packed": "window_packed",
                 "window_grouped": "window_grouped",
                 "sync_counters": "sync_counters",
                 "debit_packed": "debit_packed",
                 "acquire_scan_packed": "acquire_scan",
                 "window_scan_packed": "window_scan"}


def _record_sizes(ck, sizes: dict) -> None:
    """Wrap each of :data:`SIZED_KERNELS` in ``ck`` so that a call on a
    CUDA operand (second argument) counts its rows in ``sizes[kernel]``."""
    for wrapper, name in SIZED_KERNELS.items():
        fn = getattr(ck, wrapper)
        counts = sizes.setdefault(name, {})

        def recorded(state, packed, *args, _fn=fn, _counts=counts,
                     _scan=wrapper.endswith("_scan_packed"), **kwargs):
            if packed.device.type == "cuda":
                # A scan's u8[K, B, 5] or i32[2, K, B] operand: K x B rows.
                b = (packed.numel() // (5 if packed.element_size() == 1
                                        else 2)
                     if _scan else int(packed.shape[-1]))
                _counts[b] = _counts.get(b, 0) + 1
            return _fn(state, packed, *args, **kwargs)

        setattr(ck, wrapper, recorded)


def _sizes_since(sizes: dict, before: dict) -> dict:
    """The launches by width made since ``before`` (a copy of ``sizes``)."""
    out = {}
    for name, counts in sizes.items():
        was = before.get(name, {})
        new = {b: c - was.get(b, 0) for b, c in counts.items()
               if c > was.get(b, 0)}
        if new:
            out[name] = dict(sorted(new.items()))
    return out


def _paths() -> tuple:
    """The paths of phases 3–10 and 12–20, in the order :func:`main`
    runs them."""
    return (("exact", main_path), ("approximate", approximate_path),
            ("window", window_path), ("admission", admission_path),
            ("reservation", reservation_path),
            ("checkpoint", checkpoint_path),
            ("observability", observability_path),
            ("server", server_path), ("bench", bench_path),
            ("native", native_path), ("fp", fp_path), ("mesh", mesh_path),
            ("placement", placement_path), ("config", config_path),
            ("drain", drain_path), ("cluster", cluster_path),
            ("federation", federation_path))


#: The paths :func:`main` runs in processes of their own (the side lanes,
#: each lane's paths in order) while its own process runs
#: :data:`BESIDE_SIDE_LANE`; the exact path runs before them (its device
#: trace in a young process, ROADMAP C1) and the rest of :func:`_paths`
#: after every lane has ended, alone. The lanes' checks are state checks
#: on their own stores; the paths measured against earlier PRs' rates (the
#: exact, server, bench, native and observability paths) and the drain's
#: timed window run alone. With one side lane (fp, mesh, checkpoint) and
#: the federation path beside it, the script took 805 s on a fast host and
#: 1,059 s on a slow one (H100 80GB HBM3, 700 W), each half of the lanes
#: 498 s there. Its paths' walls in that run (cluster 150 s, checkpoint
#: 192, reservation 95, fp 83, mesh 140, placement 65, config 85,
#: federation 70, admission 15, window 15, approximate 4) make the four
#: groups below, three side lanes and this process, 219-245 s each; the
#: lanes then took 318 s of an 886 s script. No path is cut for it.
SIDE_LANES = (("cluster", "reservation"),
              ("checkpoint", "approximate", "window", "admission"),
              ("fp", "mesh"))
BESIDE_SIDE_LANE = ("placement", "config", "federation")
#: Set in a side lane's process: the parent ran the fp and mesh kernel
#: cases, so the fp and mesh paths do not run them again.
_KERNEL_CASES_RAN = False


def _run_paths(torch, ck, pkg, card: str, names, sizes: dict) -> tuple:
    """Run the named paths of :func:`_paths` in order: ``(launches by
    path, launches by width by path, wall seconds by path)``."""
    paths = dict(_paths())
    by_path, sizes_by_path, walls = {}, {}, {}
    for name in names:
        t = time.perf_counter()
        before = {k: dict(v) for k, v in sizes.items()}
        by_path[name] = asyncio.run(paths[name](torch, ck, pkg, card))
        sizes_by_path[name] = _sizes_since(sizes, before)
        walls[name] = time.perf_counter() - t
    return by_path, sizes_by_path, walls


def _run_all_paths(torch, ck, pkg, card: str, sizes: dict) -> tuple:
    """Every path of :func:`_paths`: the exact path first; then each of
    :data:`SIDE_LANES` in a process of its own beside
    :data:`BESIDE_SIDE_LANE` in this one; the rest after them, alone.
    Returns ``(launches by path, launches by width by path, wall seconds by
    path, the lanes' wall)``, the first and third in :func:`_paths` order;
    ``sizes`` gains the side lanes' widths."""
    by_path, sizes_by_path, walls = _run_paths(torch, ck, pkg, card,
                                               ["exact"], sizes)
    t = time.perf_counter()
    lanes = []
    try:
        lanes = [_SideLane(names) for names in SIDE_LANES]
        beside = _run_paths(torch, ck, pkg, card, BESIDE_SIDE_LANE, sizes)
        sides = [lane.finish() for lane in lanes]
    finally:
        for lane in lanes:
            lane.stop()
    lane_s = time.perf_counter() - t
    in_lanes = {n for names in SIDE_LANES for n in names}
    rest = [n for n, _ in _paths() if n not in in_lanes
            and n not in BESIDE_SIDE_LANE and n != "exact"]
    for more in (beside, _run_paths(torch, ck, pkg, card, rest, sizes)):
        for got, extra in zip((by_path, sizes_by_path, walls), more):
            got.update(extra)
    for side in sides:
        by_path.update(side["by_path"])
        walls.update(side["walls"])
        for name, counts in side["sizes"].items():
            mine = sizes.setdefault(name, {})
            for b, c in counts.items():
                mine[int(b)] = mine.get(int(b), 0) + c
    order = [n for n, _ in _paths()]
    return ({n: by_path[n] for n in order}, sizes_by_path,
            {n: walls[n] for n in order}, lane_s)


def side_lane(names: list) -> int:
    """``python3 chip_smoke.py --lane NAME[,NAME...]``: :func:`main`'s side
    lane. Runs the named paths in this process, as :func:`main` would, and
    prints their lines and then one ``LANE {json}`` line with their
    launches, launch widths and walls."""
    import torch

    global _KERNEL_CASES_RAN
    _KERNEL_CASES_RAN = True
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributedratelimiting.redis_tpu_torch as pkg
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

    card = _card_line()
    ck.build()
    sizes: dict = {}
    _record_sizes(ck, sizes)
    by_path, sizes_by_path, walls = _run_paths(torch, ck, pkg, card, names,
                                               sizes)
    print("LANE " + json.dumps({"by_path": by_path, "sizes": sizes,
                                "walls": walls}), flush=True)
    return 0


class _SideLane:
    """A side lane's process: its stdout lines echoed as they come, its
    ``LANE`` line kept."""

    def __init__(self, names) -> None:
        import threading

        self.names = tuple(names)
        self.result = None
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane",
             ",".join(names)], stdout=subprocess.PIPE, text=True)
        self._pump = threading.Thread(target=self._read, daemon=True)
        self._pump.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("LANE "):
                self.result = json.loads(line[5:])
            else:
                print(line, end="", flush=True)

    def finish(self) -> dict:
        """Wait for the lane; its result, or an error if it failed."""
        rc = self.proc.wait()
        self._pump.join()
        if rc != 0 or self.result is None:
            raise AssertionError(f"the side lane {self.names} failed "
                                 f"(exit {rc})")
        return self.result

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def paths_only(names: list) -> int:
    """``python3 chip_smoke.py --paths NAME[,NAME...]``: only the named
    paths of :func:`_paths`, in that order, on the package beside this file
    (copy the script into another checkout to run that checkout's). Prints
    the card, each path's lines, wall and launches."""
    import torch

    paths = dict(_paths())
    unknown = [n for n in names if n not in paths]
    if unknown:
        print(f"chip_smoke: unknown paths {unknown}; known: {list(paths)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributedratelimiting.redis_tpu_torch as pkg
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

    card = _card_line()
    print(card)
    ck.build()
    for name in names:
        t = time.perf_counter()
        counts = asyncio.run(paths[name](torch, ck, pkg, card))
        print(f"{name} path: {time.perf_counter() - t:.1f} s, launches "
              + json.dumps({k: v for k, v in counts.items() if v}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributedratelimiting.redis_tpu_torch as pkg
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(card)
    t0 = time.perf_counter()
    report = ck.build()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    with open(ck.BUILD_DIR / "nvcc.log", "w") as f:
        for name, r in report.items():
            f.write(f"== {name} ({r['seconds']:.1f} s)\n{r['log']}\n")

    dev = torch.device("cuda")
    phases = {}
    t = time.perf_counter()
    res = kernel_phase(torch, K, ck, dev)
    phases["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    _fp_kernel_phase(torch, ck, card)
    phases["fp kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    _mesh_kernel_phase(torch, ck, card)
    phases["mesh kernels"] = time.perf_counter() - t
    # Each path resets the counts just before it runs and reads them just
    # after; a kernel's launches are its count summed over the paths, and
    # it must have launched on the path it serves.
    sizes: dict = {}
    _record_sizes(ck, sizes)
    by_path, sizes_by_path, walls, lane_s = _run_all_paths(torch, ck, pkg,
                                                           card, sizes)
    phases["side lanes " + " | ".join("+".join(names)
                                      for names in SIDE_LANES)] = lane_s
    phases.update(walls)
    # The fp and mesh kernel cases (run before any path's counts were reset).
    res.update(FP_RESULTS)
    res.update(MESH_RESULTS)
    # The server's launches by width: every bulk frame of at most max_batch
    # rows (the coalescing client's frames) is one flush of its rows, and
    # no scan launch holds a single batch.
    server_sizes = sizes_by_path["server"]
    print(f"server launches by width ({card}): "
          + json.dumps({k: {str(b): c for b, c in v.items()}
                        for k, v in server_sizes.items()}))
    one_batch = {k: {b: c for b, c in server_sizes.get(k, {}).items()
                     if b <= BATCH}
                 for k in ("acquire_scan", "window_scan")}
    if any(one_batch.values()):
        raise AssertionError(f"server path: scans of one batch {one_batch}")
    t = time.perf_counter()
    cli_server(pkg)
    phases["console server"] = time.perf_counter() - t
    print("phase wall seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))
    serves = {"sweep_expired": "exact", "acquire_packed": "exact",
              "acquire_grouped": "exact", "acquire_scan": "exact",
              "sync_counters": "approximate", "sweep_counters": "approximate",
              "window_packed": "window", "window_grouped": "window",
              "window_scan": "window", "sweep_windows": "window",
              "sema_packed": "admission", "sweep_semas": "admission",
              "acquire_hierarchical": "admission", "debit_packed": "exact",
              "acquire_scan24": "bench", "acquire_batch": "bench",
              **{name: "fp" for name in FP_KERNEL_NAMES},
              "global_tier": "mesh"}
    # No wire op reaches the bench's two kernels: they are exempt from the
    # server-path rule (OP_SETTLE reaches the debit). The fingerprint
    # kernels serve the fp store, which the server path does not run (the fp
    # path serves it through ``--directory fp``).
    no_wire_op = {"acquire_scan24": "the bench's kernel, no wire op",
                  "acquire_batch": "the bench's kernel, no wire op",
                  **{name: "the fingerprint store's kernel: the fp path "
                           "serves --directory fp" for name in FP_KERNEL_NAMES},
                  "global_tier": "the mesh store's kernel: the mesh path "
                                 "serves --backend mesh"}
    # The reservation path runs on the two-level kernel and the debit; the
    # checkpoint path (its oracle's traffic, the chain's fill and the day-
    # later sweep between saves) on every bucket, counter and semaphore
    # kernel of the store, the window scan and the window sweep.
    also_serves = {"reservation": ("acquire_hierarchical", "debit_packed"),
                   "checkpoint": ("sweep_expired", "acquire_packed",
                                  "acquire_grouped", "acquire_scan",
                                  "window_scan", "sync_counters",
                                  "sema_packed", "acquire_hierarchical",
                                  "debit_packed", "sweep_windows",
                                  "sweep_counters", "sweep_semas"),
                   # The plane's traffic: per-request flushes (Zipf hot
                   # keys repeat in one), bulk frames and the device
                   # trace's bulk, reserves and their settles.
                   "observability": ("acquire_packed", "acquire_grouped",
                                     "acquire_scan", "acquire_hierarchical",
                                     "debit_packed"),
                   # The native front-end's lanes: the batch lane's
                   # flushes, the bulk residue's scan and tier-0's debit.
                   "native": ("acquire_packed", "window_packed",
                              "sema_packed", "acquire_scan",
                              "debit_packed"),
                   # The mesh: its decisions (the bucket and window scans,
                   # the fp decision), sweeps none, the aux store's flushes
                   # none; every fp decision of the fp tier.
                   "mesh": ("acquire_scan", "window_scan", "fp_decide"),
                   # Placement: the import's and the source's debits, the
                   # generic lane's window, counter and semaphore replays,
                   # and the traffic (bulk calls, one-batch frames).
                   "placement": ("debit_packed", "window_packed",
                                 "sync_counters", "sema_packed",
                                 "acquire_scan", "acquire_packed"),
                   # Live config: the rebase's debit and window flushes,
                   # tier-0's retire (the debit), the load's bulk calls and
                   # the per-request asks (flushes).
                   "config": ("debit_packed", "window_packed",
                              "acquire_scan", "acquire_packed"),
                   # Drain: the source's debit and the import's (buckets,
                   # the relayed settles' refunds), the import's window,
                   # counter and semaphore replays, the load's bulk calls
                   # and holds, the asks through the successor.
                   "drain": ("debit_packed", "window_packed",
                             "sync_counters", "sema_packed", "acquire_scan",
                             "acquire_hierarchical"),
                   # The cluster: the fan-out's bulk calls (scans), the
                   # routed single ops and the rejoin debit (flushes), the
                   # window asks (repeated keys: grouped flushes) and the
                   # import's window replays, counters, semaphores and
                   # two-level rows, the scale-out's import and the settles
                   # (the debit), the final sweep.
                   "cluster": ("acquire_scan", "acquire_packed",
                               "window_grouped", "window_packed",
                               "sync_counters", "sema_packed",
                               "acquire_hierarchical", "debit_packed",
                               "sweep_expired"),
                   # Federation: the home's renew charges, reclaims and
                   # heal refunds, and every region's rebase (the debit).
                   "federation": ("debit_packed",)}

    sources = {"sweep_expired": "csrc/sweep.cu",
               "acquire_packed": "csrc/acquire.cu",
               "acquire_grouped": "csrc/acquire.cu",
               "acquire_scan": "csrc/acquire.cu",
               "sync_counters": "csrc/counter.cu",
               "sweep_counters": "csrc/counter.cu",
               "window_packed": "csrc/window.cu",
               "window_grouped": "csrc/window.cu",
               "window_scan": "csrc/window.cu",
               "sweep_windows": "csrc/window.cu",
               "sema_packed": "csrc/sema.cu",
               "sweep_semas": "csrc/sema.cu",
               "acquire_hierarchical": "csrc/admission.cu",
               "debit_packed": "csrc/admission.cu",
               "acquire_scan24": "csrc/acquire.cu",
               "acquire_batch": "csrc/acquire.cu",
               **{name: "csrc/fp_directory.cu" for name in FP_KERNEL_NAMES},
               # The decisions: decide.cuh's fingerprint form, entered here.
               "fp_decide": "csrc/acquire.cu",
               "fp_window_decide": "csrc/window.cu",
               "global_tier": "csrc/mesh.cu"}
    replaces = {
        "sweep_expired":
            "distributedratelimiting/redis_tpu/ops/pallas_kernels.py:80",
        "acquire_packed":
            "distributedratelimiting/redis_tpu/ops/kernels.py:239",
        "acquire_grouped":
            "distributedratelimiting/redis_tpu/ops/kernels.py:257",
        # acquire_scan_fused_packed; also _bits (:451) and
        # acquire_scan_compact_packed (:383).
        "acquire_scan":
            "distributedratelimiting/redis_tpu/ops/kernels.py:479",
        # core _sync_core (:728)
        "sync_counters":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1085",
        "sweep_counters":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1220",
        "window_packed":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1103",
        "window_grouped":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1117",
        # window_acquire_scan_fused_packed; also _fused_bits (:638),
        # window_acquire_scan (:613) and window_acquire_scan_compact (:687).
        "window_scan":
            "distributedratelimiting/redis_tpu/ops/kernels.py:663",
        "sweep_windows":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1233",
        "sema_packed":
            "distributedratelimiting/redis_tpu/ops/kernels.py:840",
        "sweep_semas":
            "distributedratelimiting/redis_tpu/ops/kernels.py:921",
        "acquire_hierarchical":
            "distributedratelimiting/redis_tpu/ops/kernels.py:945",
        "debit_packed":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1033",
        # The scan's 3-byte operand (the bench's headline).
        "acquire_scan24":
            "distributedratelimiting/redis_tpu/ops/kernels.py:573",
        # core acquire_core (:153); the scan at K = 1 over separate arrays.
        "acquire_batch":
            "distributedratelimiting/redis_tpu/ops/kernels.py:197",
        # The fingerprint directory: each runs fp_resolve_core (:124) first.
        # fp_acquire_batch; also fp_acquire_scan_fused (:320) and _bits
        # (:290).
        "fp_decide":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:225",
        # fp_window_acquire_batch; also its scans (:522, :495).
        "fp_window_decide":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:476",
        "fp_debit":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:349",
        "fp_peek":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:403",
        "fp_sweep":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:574",
        "fp_sweep_windows":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:560",
        # core _fp_migrate_core (:427)
        "fp_migrate":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:448",
        "fp_migrate_window":
            "distributedratelimiting/redis_tpu/ops/fp_directory.py:548",
        # global_tier_update (:75) with the psum before it (:201, :243,
        # :304; fp_sharded.py:180, :192).
        "global_tier":
            "distributedratelimiting/redis_tpu/parallel/sharded_store.py:75",
    }
    kernels = []
    for name, r in res.items():
        bound_ms, bound_by = _bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributedratelimiting/redis_tpu_torch/"
                      + sources[name],
            "replaces": replaces[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
        if "shapes" in r:  # the kernels at the added shapes
            kernels[-1]["shapes"] = r["shapes"]
        if name in sizes:  # launches on the paths by operand width B
            kernels[-1]["launch_sizes"] = {
                str(b): c for b, c in sorted(sizes[name].items())}
        if name in no_wire_op:
            kernels[-1]["server_path"] = "exempt: " + no_wire_op[name]
    print(json.dumps({"kernels": kernels}))
    # Each kernel launched on the path it serves, and the server path drives
    # every kernel that a wire op reaches.
    idle = [f"{name} ({path} path)" for name, path in serves.items()
            if by_path[path][name] <= 0]
    idle += [f"{name} (server path)" for name in serves
             if name not in no_wire_op and by_path["server"][name] <= 0]
    idle += [f"{name} ({path} path)" for path, names in also_serves.items()
             for name in names if by_path[path][name] <= 0]
    # Federation's asks reach a bucket flush: the plain one where a tenant's
    # asks of one flush are one row, the grouped one where they repeat —
    # which, the flush's timing decides (both > 0 in every run so far).
    fed = by_path["federation"]
    if fed["acquire_packed"] + fed["acquire_grouped"] <= 0:
        idle.append("acquire_packed or acquire_grouped (federation path)")
    if idle:
        raise AssertionError(f"never launched: {idle}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scalar-client"]:
        # A client process of the server path (see scalar_client).
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import distributedratelimiting.redis_tpu_torch as _pkg

        print(json.dumps(asyncio.run(scalar_client(
            _pkg, (sys.argv[2], int(sys.argv[3])), int(sys.argv[4])))))
        sys.exit(0)
    if sys.argv[1:2] == ["--obs-client"]:
        # A client process of the observability path (see obs_client).
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import distributedratelimiting.redis_tpu_torch as _pkg

        print(json.dumps(asyncio.run(obs_client(
            _pkg, sys.argv[2], [int(p) for p in sys.argv[3].split(",")],
            sys.argv[4], *map(int, sys.argv[5:8])))))
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-client"]:
        # The mesh path's wire client (see mesh_client).
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import distributedratelimiting.redis_tpu_torch as _pkg

        print(json.dumps(asyncio.run(mesh_client(
            _pkg, (sys.argv[2], int(sys.argv[3]))))))
        sys.exit(0)
    if sys.argv[1:2] == ["--native-client"]:
        # A client process of the native path (see _native_client_run).
        print(json.dumps(asyncio.run(_native_client_run(
            sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5:]))))
        sys.exit(0)
    if sys.argv[1:2] == ["--obs-device-trace"]:
        # The observability path's device trace (see obs_device_trace).
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import distributedratelimiting.redis_tpu_torch as _pkg

        print(json.dumps(asyncio.run(obs_device_trace(
            _pkg, sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5]))))
        sys.exit(0)
    if sys.argv[1:2] == ["--scan-bench"]:
        sys.exit(scan_bench())
    if sys.argv[1:2] == ["--admission-bench"]:
        sys.exit(admission_bench())
    if sys.argv[1:2] == ["--flush-bench"]:
        sys.exit(flush_bench())
    if sys.argv[1:2] == ["--sync-bench"]:
        sys.exit(sync_bench())
    if sys.argv[1:2] == ["--fp-bench"]:
        sys.exit(fp_bench())
    if sys.argv[1:2] == ["--window-traffic"]:
        sys.exit(window_traffic())
    if sys.argv[1:2] == ["--lane"] and len(sys.argv) == 3:
        sys.exit(side_lane(sys.argv[2].split(",")))
    if sys.argv[1:2] == ["--paths"] and len(sys.argv) == 3:
        sys.exit(paths_only(sys.argv[2].split(",")))
    sys.exit(main())

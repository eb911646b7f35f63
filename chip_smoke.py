#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]
    python3 chip_smoke.py --pool-ready <checkout root>   # only the worker pool's start-up, 3 times

Phases, each of which fails the script (non-zero exit) on any error:

1. build: compile the port's CUDA kernels from their seven sources in
   ``ray_shuffling_data_loader_tpu_torch/ops/csrc/`` (``interaction.cu``,
   ``flash_fwd.cu``, ``flash_bwd.cu`` and the tensor-core route's
   ``interaction_mma.cu``, ``flash_fwd_mma.cu``, ``flash_bwd_dkv_mma.cu``,
   ``flash_bwd_dq_mma.cu``; one ``nvcc`` each, all started together) into
   ``build/kernels/`` and log each kernel's registers and spills;
   lint, beside the build's ``nvcc``: the port's static analysis
   (``python -m ray_shuffling_data_loader_tpu_torch.rsdl_lint --json``)
   over the tree as shipped must exit 0 with 0 active findings and the
   reviewed count of suppressed ones, each with its reason; and the
   runtime twin of its gate-integrity check, with CUDA present and every
   ``RSDL_*`` unset: import the port's ``runtime``, ``runtime.actor``,
   ``shuffle``, ``dataset`` and ``device_dataset``, touch the card, one
   ``runtime.init``, submit and shutdown, and then none of
   ``telemetry.trace``, ``telemetry.audit``, ``telemetry.export`` or
   ``runtime.faults`` may be loaded; logs both one's seconds;
   native: build the shuffle's host kernels
   (``ray_shuffling_data_loader_tpu_torch/native/kernels.cc``, g++) and
   hold every entry point against its plain numpy version, bit for bit, at
   the shapes the shuffle gives it: the map of one Quick-start file
   (100,000 rows, 21 columns, 8 reducers: the narrowing and the group-by
   scatter), one reducer's fused concat-gather over 8 parts and its
   permutation (125,000 rows), one file of the resident phase (744,048
   rows: the group-by, the scatter) and the probe's 8 M rows (both
   gathers, the scatter, the group-by, the narrowing); log each one's
   GB/s, its numpy version's and its thread count against the host's
   copy rate, and the schedule policy's probe with the kernels on and off;
2. kernel: hold each kernel against its plain PyTorch version on the card:
   the interaction (K1) on its tensor-core route at the DLRM's ``(65536,
   19, 32)`` bf16, the resident phase's ``(250000, 19, 32)``, the pod
   phase's rank shard ``(16384, 19, 32)``, a batch
   ragged against its tile ``(1001, 19, 32)``,
   ``(500, 27, 16)``, ``(4096, 64, 64)`` and ``(8192, 27, 128)`` in bf16,
   and on its CUDA-core route at the DLRM's shape and a ragged ``(500, 27,
   16)`` fp32; the flash forward (K2, output and the ``m``,
   ``l`` statistics) and backward (K3: dK, dV; K4: dQ) at the
   TabTransformer's ``[65536, 19, 4, 8]`` bf16 (q, k, v strided views of
   one ``[b, t, 3, h, hd]`` tensor, dQ, dK, dV views of one packed
   gradient), the CausalLM's ``[4, 512, 4, 16]`` bf16 causal, ``[2, 4096,
   8, 64]`` bf16 causal and not, ``[1, 300, 2, 8]`` fp32 causal, ``[2, 56,
   2, 8]`` fp32, shapes of every head-dim bucket of both routes (ragged
   t among them) and one bf16 shape on each side of ``T_MIN``; every case
   the tensor-core route takes on both routes of K2, K3 and K4; and the
   autograd Function over the packed tensor (default routes) at the same
   shapes.
   Time every kernel beside its bound, its plain version and the PyTorch
   library call that computes the same, at the main paths' shapes (K1 also
   at the resident and the pod phases', logged), at the sp trainer's (a ring hop's
   ``[2, 128, 4, 16]``, causal and not, and Ulysses' ``[2, 512, 1, 16]``
   causal) and at ``[2, 4096, 8, 64]`` bf16, causal and not, K1 to K4 on
   both routes;
   and sweep both routes of K2, K3 and K4 at ``[4, t, 4, hd]`` causal, hd
   16 and 64, t 32 to 256, where ``T_MIN`` was chosen;
3. slices: write the README's Quick-start dataset (10^6 rows, 10 files,
   5 row groups each) and, for each of the full-width
   ``dlrm_for_data_spec()`` and ``transformer_for_data_spec()``, shuffle it
   for 2 epochs through ``DeviceShufflingDataset`` on ``cuda`` (batch
   65536, 8 reducers) and train on every batch with Adam 1e-3 (the DLRM
   under deterministic algorithms, its initial weights and its staged
   tensors' per-batch digests kept for the uri phase). Each epoch
   must deliver every key at most once and exactly the full batches'
   worth, every loss must be finite, and over the path the interaction
   kernel must launch once per DLRM step, all on its tensor-core route,
   and each flash kernel twice per TabTransformer step (two layers), none
   on a tensor-core route. The loader runs its defaults (decode cache,
   the schedule policy, packed reducer outputs staged in one copy): each
   epoch must stage at least one batch direct, and each run logs its
   schedules, the resolved ``cache_decoded``, the decoded-size estimate
   against the store's budget, the host probe's figures, direct and
   carried batches with the host time per batch of each kind, the
   staging stall, each epoch's shuffle seconds and the store's peak;
   every run's host passes (take or take_multi, the narrowing, the
   group-by scatter) must have run on the C++ kernels and none on numpy;
   delivery: on the same dataset, delivery only (no step) for 2 epochs
   six ways: the defaults; ``RSDL_INDEX_SHUFFLE=on``;
   ``RSDL_DEVICE_DIRECT=off``, ``RSDL_INDEX_SHUFFLE=off`` with
   ``cache_decoded=False``; ``RSDL_DISABLE_NATIVE=1``;
   ``RSDL_SHUFFLE_PLAN=block:1``; and ``RSDL_SHUFFLE_PLAN=block:1
   RSDL_SELECTIVE_READS=auto``. Each epoch must deliver every key at most
   once and the full batches' worth. Every staged tensor of every batch
   must be equal across the first four and across the last two
   (per-batch digests computed on the card), and differ between the two
   groups; the forced run must take the index schedule in epoch 1, the
   all-off run must stage nothing direct and cache nothing, the host
   passes must run on the C++ kernels (on numpy alone with
   ``RSDL_DISABLE_NATIVE=1``), and the selective run must take the
   selective schedule in both epochs and decode each of the dataset's 50
   row groups once an epoch. Each run logs a profile
   of the stager's thread: the median ms of one stage per kind of batch
   (direct; carried, still a view of a segment's mapping; carried, rows
   the carry concatenated) and of the consumer's mapping of a segment;
   uri: the same path read and reported through ``file://`` URIs
   (``utils.parquet_filesystem``: pyarrow's own filesystem, no fsspec):
   the dataset written again with ``generate_data(...,
   "file://<root>/build/uri_data")``, whose files must decode to the
   same-index local files' columns (byte equality logged); the DLRM slice
   over the URIs from the slices phase's initial weights, both runs under
   deterministic algorithms, whose staged tensors (per-batch digests on
   the card) and 30 losses must equal the slices phase's DLRM run's bit
   for bit, with K1 once a step on its tensor-core route
   (``launches_uri``); ``dataset_num_rows`` over the URIs 10^6, and a
   resident staging of the URIs the local files' packed buffer and epoch-0
   keys; ``process_stats`` of the URI run's trial to
   ``file://<root>/build/uri_stats/uri`` the three CSVs with a local
   write's headers and rows, and with ``overwrite_stats=False`` twice
   their rows; fsspec never imported. Logs the maps' decode seconds per
   epoch through the resolver beside the local run's;
4. ranks: data-parallel DLRM training with one process per trainer rank
   (``multirank``) on the same dataset, all ranks on ``cuda:0``: 2 ranks
   over ``gloo`` with ``DistributedDataParallel`` (mean) for 1 epoch; 3
   ranks over ``gloo`` with ``make_psum_train_step`` (Adasum, bf16 on the
   wire) for 1 epoch; 1 rank over ``nccl`` with ``make_psum_train_step``
   (mean, bf16 on the wire) for 3 steps; and ``dp2_mp2``: 4 ranks over
   ``gloo``, 2 trainers × ``--model-parallelism 2`` with DDP over each data
   group for 1 epoch, ``embeddings_name12`` and ``embeddings_name14``
   sharded by rows over each model group (and nothing else), whose lead
   reads the batch and broadcasts it to its peer; batch 65536 per data
   index, 8 reducers in rank 0's spawned worker pool, the full-width DLRM
   in bf16. The four runs go side by side in one round, each run a
   process of this script (``--ranks-run``) whose session has 4 pool
   workers, so that their step times are those of four runs sharing the
   card. Ranks step until the last one runs out (a rank whose shard is
   done steps on its last batch with its loss weighted 0). In each run
   every epoch must deliver each key at most once across the leads and
   each lead exactly its full batches, all trained by every rank of its
   model group, every loss must be finite, every rank must log the same
   loss (the global batch's) at every step, the replicated parameters
   must be bit-identical on every rank, each shard across its data group
   and the gathered state on every rank, and each rank must launch the
   interaction kernel once per step, all on its tensor-core route, and no
   flash kernel; ``dp2_mp2``'s losses must be within 1e-4 of
   ``ddp_mean_2``'s epoch 0 (the same batches). Each rank logs its
   parameter and peak device bytes, the data-group reduce and the
   lookup's model-group sum timed alone with their bytes, and its
   start-up and shutdown (seconds since spawn to imports, runtime joined,
   process groups, model built and sharded, optimizer made, step made,
   pool ready, first batch, last step, report written, teardown);
   audit: the audit plane on the same dataset (``RSDL_AUDIT=1``, a spool
   under ``build/audit/``, the session and its pool started after both):
   (a) the DLRM slice of the slices phase, audited: every epoch's
   verdict must be ``ok`` with map == reduce == delivered == consumed ==
   10^6 rows, and K1 must launch once per step on its tensor-core route
   (``launches_audit`` in the kernels line); (b) delivery only with
   ``drop_last=False``: staged == delivered; (c) that run under
   ``RSDL_JOURNAL``: one ``verdict`` per epoch in the journal, and
   ``python -m ray_shuffling_data_loader_tpu_torch.replay`` on it must
   exit 0 for every epoch; (d) ``drop-row`` armed in epoch 0 of two:
   ``ok`` False with ``["delivered"]`` in epoch 0 alone, and under
   ``RSDL_AUDIT_STRICT=1`` the run must raise ``AuditError``; (e) logs
   the audited run's shuffle seconds, step median and stall share beside
   the slices phase's unaudited run, the digest seconds of each side, the
   spool's bytes and the seconds of the reconcile and the replay;
   cluster: the multi-host cluster plane on the same dataset, two hosts on
   one machine, each with its own shared-memory and spill directories and
   4 pool workers, one audit spool (``RSDL_AUDIT=1``). A head process
   (this script with ``--cluster-head``) trains the DLRM slice (2 epochs,
   deterministic algorithms, the same initial weights) on one host alone,
   then on a cluster (``init_cluster``) that a second host joins with
   ``python -m ray_shuffling_data_loader_tpu_torch.runtime.cluster join``:
   the cluster's staged tensors (per-batch digests on the card) and losses
   must equal the one host's bit for bit, both epochs reconcile ``ok`` with
   10^6 rows mapped = reduced = delivered = consumed and the one host's
   digests, both agents complete tasks, the store servers serve bytes to
   the other host, the reduces take the overlapped path (``scatter``), and
   K1 launch once a step on its tensor-core route (``launches_cluster``).
   The same tensors again, delivery only, with
   ``RSDL_REDUCE_FETCH_OVERLAP=off`` (no ``scatter``) and on a second
   cluster with ``RSDL_TCP_ZEROCOPY=1 RSDL_TCP_STREAMS=4``; no segment may be
   left in any host's directories. Logs each run's shuffle seconds per
   epoch, step median and stall share beside the slices phase's, and the
   loopback fetch's GB/s of a 256 MiB segment (pickled, zero-copy on 1
   and 4 streams);
   faults: the fault plane and stage recovery on the same dataset, in a
   head process of its own (this script with ``--faults-head``), held to
   the cluster phase's one-host run (audited, deterministic, the same
   initial weights) as its reference. (a) The recovered run: the DLRM
   slice for 2 epochs over 2 pool workers under one seeded schedule
   (``FAULTS_SPEC``: a crashed map entry and a crashed reduce exit in each
   epoch, a reduce's worker killed, a worker's store read lost, a
   driver's send to the queue actor reset), a budget of 8 attempts,
   strict audit, journaled: its staged tensors and losses must equal the
   reference's bit for bit, both epochs reconcile ``ok`` with 10^6 rows
   mapped = reduced = delivered = consumed and the reference's
   ``delivered_seq``, every kind must have fired (both crashes in both
   epochs), ``stats`` must show retries of maps and reduces and maps
   re-made from lineage, and K1 launch once a step on its tensor-core
   route (``launches_faults``); (b) ``replay`` of its journal must exit 0
   for both epochs with the schedule re-armed; (c) the poison
   (``task.map:crash-entry:1.0``, 3 attempts): the trainer's loop must
   raise ``StageFailedError`` (map, epoch 0, 3 attempts) within 60 s with
   the stager's pinned ring and side stream released; (d) failover: a
   head and a joined host (4 workers each), the joined host's process
   group SIGKILLed once epoch 0's maps are journaled (its epoch-0 reduces
   wait 8 s at entry, so none publishes first): the run must finish on
   the head with the reference's tensors and losses, both verdicts ``ok``,
   the host evicted and its maps re-made. No segment may be left in the
   surviving directories. Logs each run's shuffle seconds per epoch, step
   median and stall share beside the reference's;
   telemetry: the telemetry planes on the same dataset, in a head process
   of its own (this script with ``--telemetry-head``) started with every
   plane on (:func:`_planes_env`: ``RSDL_METRICS=1``, ``RSDL_TRACE=1``,
   ``RSDL_TS=1``, ``RSDL_PROFILE=1``, ``RSDL_RUN_LEDGER``) and the spools
   under ``build/telemetry/``. The metered run: the DLRM slice (2
   epochs, deterministic algorithms, the same initial weights) with one
   seeded ``task.map:crash`` rule armed in epoch 1 (``TELEMETRY_FAULTS``,
   budget 8); its staged tensors and losses must equal the cluster phase's
   one-host run (unmetered) bit for bit, K1 launch once a step on its
   tensor-core route (``launches_telemetry``); the aggregated spools must
   count 20 map tasks (a crash at entry counts none), 16 reduce tasks,
   at least 2 x 10^6 rows mapped and reduced, 30 ``h2d.batches``, both
   stall causes and the map and reduce stages' phase times;
   ``recovery.stage_retries{stage=map}`` must equal the run's
   ``stats["stage_retries"]``, ``faults.injected`` count at least one, the
   event log hold one ``stage.retry`` per retry and one ``epoch.done`` per
   epoch; the exported trace must load as JSON and hold both epochs'
   ``map`` and ``reduce`` spans from worker pids, ``epoch:admission`` from
   the head's, ``actor:new_epoch`` with the caller's epoch and
   ``stage:h2d`` of both epochs; the Prometheus text over the spool must
   parse line by line and ``metrics.dump_json`` hold ``queue.depth.total``
   in its final values and a sample. The head also arms the time series
   (``RSDL_TS``, every ``TS_PERIOD_S``), the profiler (``RSDL_PROFILE``)
   and the run ledger, and the metered run the shared decode cache; at
   its end (:func:`decision_checks`) the task records must count the map
   and reduce counters and none be wedged, the critical path hold one row
   an epoch and the registry's stalls by cause, the capacity ledger's
   resident bytes by tier equal the store's to the byte (the cache tier
   the shared cache's segments), every epoch have a high watermark, the
   planner's live signals equal ``capacity.view()`` and
   ``critical.analyze()``, the time series hold a sample a second of the
   run, no negative rate and a persisted file equal to its ring, the
   profiles come from the driver and the workers with ``map`` or
   ``reduce`` and ``staging`` stacks, and the run ledger hold one
   ``done`` record with its sections; the metered run is audited too, both
   epochs ``ok`` at 10^6 rows delivered. After the head, the reporting
   tools run over its artifacts as a user runs them (``python -m
   ray_shuffling_data_loader_tpu_torch.<tool>``) and must exit 0 with the
   run's own figures: ``epoch_report`` (trace, events, task records, time
   series, capacity ledger, profiles) a critical path for both epochs,
   every task record the head counted, a capacity row for both epochs,
   the profiles' frames and the event log's retries; ``run_ledger list``
   and ``show -1`` the head's one record; ``rsdl_prof top`` stacks from 2
   or more processes; ``audit_report`` the run's verdicts. Then delivery only over 3 epochs
   under ``RSDL_PLAN=auto`` with every plane on, and with metrics off (no
   signal, no re-plan): the staged tensors must be the same. Then delivery
   only with every plane off, then on. Logs the shuffle
   seconds per epoch of each, the metered run's step median and stall
   share beside the slices and cluster phases', the trace's events, each
   spool's bytes, the re-plans, a profiler tick's and a time-series
   refresh's cost and the phase's seconds;
   obs: the SLO engine, the relay and the obs server on the same dataset,
   two hosts on one machine as in the cluster phase (a head, this script
   with ``--obs-head``, and a host joined with the ``join`` CLI, 4 pool
   workers each), each session owner with its own runtime directory,
   shared-memory and spill directories and audit spool; both with
   ``RSDL_METRICS=1``, ``RSDL_AUDIT=1``, ``RSDL_PROFILE=1`` and
   ``RSDL_RELAY=auto``, the head serving ``RSDL_OBS_PORT`` (the time series
   every ``TS_PERIOD_S``) with one user SLO rule (``OBS_RULE``:
   ``shuffle.map_rows > 0``). The deterministic DLRM slice on the cluster
   while a thread scrapes ``/metrics``, ``/healthz``, ``/status`` and
   ``/alerts`` about once a second: its staged tensors and losses must
   equal the cluster phase's one-host run bit for bit and K1 launch once a
   step on its tensor-core route (``launches_obs``); at the head, both
   epochs reconcile ``ok`` (the joined host's map and reduce records come
   only through the relay), the aggregate holds both hosts' sources and
   counts 20 map and 16 reduce tasks, 30 ``h2d.batches`` and 2 x 10^6 rows
   mapped and reduced, the joined host's task records number its agent's
   tasks, the relay's sink shows the joined host fresh with bytes shipped
   and none dropped; ``/metrics`` must parse with ``rsdl_up 1`` and
   ``rsdl_obs_build_info`` of version 0.1.0, ``/healthz`` show the relay
   and both hosts' sources, ``/status`` the shuffle's epochs in flight,
   the queue's depths and 2 agents, ``/alerts`` the user rule firing and
   ``wedged_worker``, ``audit_mismatch`` and ``capacity_near_limit`` quiet,
   the run ledger count the user rule once, and ``/stragglers``,
   ``/capacity``, ``/critical``, ``/timeseries``, ``/events``,
   ``/profile`` and ``/jobs`` answer JSON; ``python -m
   ray_shuffling_data_loader_tpu_torch.rsdl_top --once --json``, with and
   without ``--fleet``, must exit 0 with a frame of those pages (2
   agents, the relay's sink and the joined host, the active alerts and
   the jobs). Logs the scrape ms per route,
   the relay's ships and bytes, and the step median and shuffle seconds
   against the cluster phase's two-host run;
   elastic: the elastic control plane on the same dataset, two hosts on
   one machine as in the obs phase (a head, this script with
   ``--elastic-head``, and a host joined with the ``join`` CLI, 4 pool
   workers each, each with its own shared-memory and spill directories,
   one audit spool), both with ``RSDL_METRICS=1``, ``RSDL_AUDIT=1`` and
   ``RSDL_AUDIT_STRICT=1``; the head with ``RSDL_ELASTIC=on`` and the loop's
   knobs (``ELASTIC_ENV``: a tick every 0.2 s, a drop age of 0) and
   ``RSDL_STORE_CAPACITY_BYTES`` at ``ELASTIC_BUDGET_SHARE`` of the cluster
   phase's one-host peak. The deterministic DLRM slice with the decode
   cache on; in epoch 1, once epoch 0 has left the fence, the loop must
   evict on its own reading (``evict.demote`` and ``evict.drop``), then the
   operator (a thread of the head) drains the joined host
   (``drain_host``: ``drained``, its live segments re-homed into the
   head's store with ``transition`` records, ``scale.drain_done``, the
   host retired in ``membership_section()``, the drain's age back at 0)
   and stops it; the loop scales up once (``RSDL_ELASTIC_UP_THRESHOLD=0``;
   by hand, logged, if no live verdict named a shuffle stage by the
   drain). The run's staged tensors and losses must equal the cluster
   phase's one-host run bit for bit, both epochs reconcile ``ok`` with
   10^6 rows mapped = reduced = delivered = consumed, K1 launch once a
   step on its tensor-core route (``launches_elastic``), ``summary()`` show
   a scale event, one drain and evicted bytes, the gauges
   ``elastic.shm_headroom_frac`` and ``elastic.workers`` be published, the
   capacity ledger's resident bytes by tier equal the store's at the run's
   end and fall to 0 after the clean-up, and no segment be left in either
   host's directories. Logs the budget and the peaks, the head's residency
   over the run, the bytes and segments demoted and dropped, the drain's
   seconds, the re-homed bytes and their GB/s, and the step median,
   stall share and shuffle seconds against the cluster phase's two-host
   run;
   service: the multi-job shuffle service on the same dataset, a head
   process (this script with ``--service-head``) with its own
   shared-memory and spill directories and one audit spool, started with
   ``SERVICE_ENV``: ``RSDL_SERVICE=auto``, metrics, the strict audit, and
   admission made to act (a watermark of 0.0001 of a 4 GiB store budget,
   a bound of 1 s). First a service-off solo run of seed 1 (the
   reference); then one session of 8 workers where two tenants register,
   dlrm-a (weight 2, seed 0, from the cluster phase's one-host initial
   state) and dlrm-b (weight 1, seed 1), each training the full-width DLRM
   for 2 epochs on its own thread inside its ``job_context`` through a
   ``DeviceShufflingDataset`` of one logical queue name, the decode cache
   on, both started at once and dlrm-b's epoch 0 held before its
   admission until dlrm-a's epoch 1 is admitted (the registry then holds
   every file dlrm-a decoded, and the two windows reach the fair share
   together). dlrm-a's staged tensors and losses must equal the cluster
   phase's one-host run bit for bit and dlrm-b's its reference's, K1
   launch once a step of both on its tensor-core route
   (``launches_service``: 60), each job's epochs reconcile ``ok`` with
   10^6 rows consumed, the two queue actors be named ``<name>--<job_id>``,
   dlrm-b's epoch 0 decode no row group with cache hits of its own, the
   fair share throttle, each job release tasks while the other has some
   queued or in flight, admission wait, both jobs be tracked, running at
   once and in the snapshot, and at the end no job be live, no claim be left and no
   segment be left. Logs the releases per job (while the other had tasks
   queued, or queued or in flight), the admission seconds, and each
   tenant's step median, stall share and shuffle seconds against the
   cluster phase's one-host run;
   plan: the read plane. The Quick-start shape (10^6 rows, 10 files, seed
   0) written with 20 row groups a file, so that at 8 reducers the plan
   compiler picks ``block:1``. Six 2-epoch DLRM runs (batch 65536, bf16,
   Adam 1e-3, the same initial weights, deterministic algorithms on):
   ``RSDL_PLAN=auto`` with the decode cache (``block:1`` planned,
   selective declined) and without it (selective engaged), each against
   the same terms set by hand (``RSDL_SHUFFLE_PLAN=block:1``,
   ``RSDL_SELECTIVE_READS`` to match, ``RSDL_DECODE_PUSHDOWN=on``); and
   ``RSDL_DECODE_PUSHDOWN=on`` against ``off`` with a layout that leaves
   out ``key``. Each pair's staged tensors (per-batch digests on the
   card) and losses must be bit-identical, every epoch must deliver the
   full batches' worth (each key once where ``key`` is staged), K1 must
   launch once per step on its tensor-core route, and the layout's
   projection must prune bytes. Then delivery only (``shuffle()``, 8
   reducers): an explicit projection of ``key``, ``labels`` and
   ``embeddings_name0`` to ``_name7`` must deliver every key once an
   epoch and exactly those columns, logged with its estimate and the
   schedules ``auto`` chose beside the full decode's; and two runs back
   to back with ``RSDL_DECODE_CACHE_SHARED=on``: the second must decode
   no Parquet in epoch 0 and deliver the first's stream. Each run logs
   its terms, schedules, shuffle seconds, row groups and bytes decoded,
   the pruned bytes and the shared cache's hits;
5. resident: the JAX package's flagship path at ``bench.py``'s quick
   shape: 11,904,761 rows in 16 files of 2 row groups (seed 0), batch
   250,000 (47 full batches per epoch), 2 epochs, seed 0; the 19 feature
   columns, ``key`` (for the checks; the DLRM reads only its columns) and
   the label: 21 packed columns. ``fits_device`` must say yes; the
   staging is logged (seconds, pieces, bytes, peak device bytes). Epoch 0
   per batch through two ``DeviceResidentShufflingDataset``s, the
   materialized schedule (the budget's choice, which must be it) and the
   gather schedule: the delivered keys must equal
   ``epoch_permutation(0, 0, n)[:47 * 250000]`` computed on the CPU, in
   both. Epoch 1 on the full-width ``dlrm_for_data_spec()`` (Adam 1e-3,
   ``capturable=True``): an eager loop over the materialized dataset's
   batches, then from the same initial weights and a fresh optimizer the
   fused epoch (``make_fused_epoch``: one CUDA-graph capture, 47 replays)
   on each schedule; each fused epoch's losses must be within 1e-5 of the
   eager loop's, K1 must be captured once per step on its tensor-core
   route (its launches on this path are the captured launches times the
   replays). Logs ms per batch (CUDA events) and rows/s of the eager and
   the fused epoch and the permutation's ms. A ``TrialStatsCollector``
   hears the materialized dataset and, in ``[slice dlrm]``, the DLRM
   slice; ``process_stats`` writes their CSVs under ``build/stats/``;
6. lm: 20 Adam (3e-3) steps of ``CausalLM(vocab 64, seq 512, embed 64, 2
   layers, 4 heads)`` on ``synthetic_tokens(4, 512, 64)``; the loss must
   fall and each flash kernel launch twice per step, all on the
   tensor-core route;
7. sp: sequence parallelism. (a) The ops: one group of 4 ``gloo`` ranks
   on the card (this script with ``--sp-op-rank``) runs ring attention,
   causal and not, and Ulysses, causal, at the CausalLM's global ``[4,
   512, 4, 16]`` and at ``[2, 4096, 8, 64]``, bf16, each rank on its
   sequence chunk. Each case's output and q, k, v gradients with the
   kernels must match the same op's plain tensor code (``use_flash=False``)
   on the card and one process's fp32 dense attention on the whole
   sequence; rank ``me`` must launch K2 ``me + 1`` times in a causal ring
   and 4 times in a full one (no K3, K4: the ring's backward is tensor
   code), and Ulysses one K2, K3 and K4, all on the tensor-core route; at
   the long shape the causal ring's peak device bytes must lie below the
   dense op's (q, k, v all-gathered, dense attention on the whole
   sequence); each version's fwd+bwd ms are logged. (b) The slice:
   ``python -m ray_shuffling_data_loader_tpu_torch.train_long_context
   --backend gloo --attention ring ulysses`` at its defaults (the JAX
   example's: vocab 64, seq 512, embed 64, 2 layers, 4 heads, batch 4,
   Adam 3e-3, 20 steps, seed 0, bf16; dp 2 x sp 4 = 8 ranks on ``cuda:0``):
   each run's loss must fall, its step 0 be within 2e-3 of one process's
   ``CausalLM`` on the same weights and tokens, its parameters
   bit-identical on all 8 ranks, and each rank must launch K2 2(s + 1)
   times a step in the ring (sp index s) and K2, K3, K4 twice a step in
   Ulysses, all on the tensor-core route. Logs each rank's step median,
   the collectives' share of a step, peak device bytes and start-up;
8. parity: one batch through each trained module on ``cuda`` (kernels;
   in fp32 the interaction's CUDA-core route) and through the same module
   with the same weights on the CPU (plain versions), in fp32 with TF32
   off;
9. resume: the trainer (``python -m
   ray_shuffling_data_loader_tpu_torch.train_dlrm``) preempted and
   restarted (run after the service phase), on the slices' Quick-start
   dataset (10^6 rows, 10 files, seed 0; the trainers reuse its files)
   with the full-width DLRM (bf16, Adam 1e-3), batch 65536 (15 batches an
   epoch), 2 epochs, ``--loader mapreduce``, ``RSDL_JOURNAL`` set and a
   checkpoint every 8 steps. The runs go side by side on the card, each
   with its own shm directory, journal and 4 pool workers: the control
   and both victims, and each resume as soon as its own victim is dead. A
   control
   run goes uninterrupted (its shm directory empty after it); a victim,
   in a session of its own, SIGKILLs its own process group (this script's
   child code wraps its train step) after step 10, its last checkpoint
   at step 8; the resume (``RSDL_RESUME=redeliver``) must train steps 9
   to 30 on the control's ``key`` batches bit for bit with losses within
   1e-5, re-attach more than 0 journaled stages, launch K1 once per step
   trained on its tensor-core route, and leave no segment of either
   session in its shm directory. Then a victim and a resume with
   ``--loader resident``, whose keys must be ``epoch_permutation``'s.
   Logs the checkpoint's bytes and save seconds, the restore seconds, the
   seconds from the restart to its first batch, the stages re-attached and
   re-executed, and the steps replayed;
10. pod: the pod trainer (``python -m ray_shuffling_data_loader_tpu_torch.pod
   --simulate-pod 4 --loader resident --backend gloo``, run after the
   resume phase) as four processes on ``cuda:0``, on the slices' dataset
   (10^6 rows, 10 files, 5 row groups, seed 0; a manifest lets the
   trainer reuse its files), the full-width ``dlrm_for_data_spec()``
   (bf16, Adam 1e-3, one initial state from seed 0), global batch 65536
   (16384 a rank, 15 full batches an epoch, 16,960 rows dropped), 2
   epochs: epoch 0 through the iterator on the materialized schedule,
   epoch 1 through the multi-process fused epoch, and the gather
   schedule's epoch 0 delivered without training. Each rank stages its
   span of 250,000 rows (the boundaries at 250,000 and 750,000 fall inside
   a row group of files 2 and 7: the range decode). The ranks' shards
   joined in data-index order must equal the one-process
   ``DeviceResidentShufflingDataset``'s batches (same files and seed,
   batch 65536) key for key on both schedules, each epoch deliver every
   key at most once and exactly 983,040, every rank's pod-consistent
   ``fits_device`` say yes and the schedule be the same on every rank, the
   global loss at step 0 be within 1e-4 of a one-process eager DLRM's on
   the same weights and global batches and every later loss within 1e-2
   (the largest difference logged), the parameters be bit-identical on the
   four ranks, and K1 launch once a step on every rank on its tensor-core
   route (30 a rank, 120 in all: ``launches_pod``; the fused epoch's as
   captured launches times replays). Logs the staging seconds and bytes
   a rank, the materialized exchange's and the gather schedule's seconds
   an epoch, the step median, the fused epoch's collectives' share, its
   ms a batch against the eager loop's, spawn to first step and the
   phase's wall.

The heads of the cluster, faults, telemetry, obs, elastic and service
phases start while the phase before theirs runs (Python, torch, CUDA and
the optimizer's imports), then wait for the spec their phase writes.
Every launch count is set to 0 just before a path is driven and read just
after; in the ranks phase, by each rank in its own process. Logs each
phase's wall seconds at the end. Prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import csv
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
T_PROCESS = time.perf_counter()  # the script's start, before torch's import and the card's first use
KERNEL_SOURCES = ("interaction", "flash_fwd", "flash_bwd", "interaction_mma", "flash_fwd_mma",
                  "flash_bwd_dkv_mma", "flash_bwd_dq_mma")
CSRC = "ray_shuffling_data_loader_tpu_torch/ops/csrc/"
JAX_FLASH = "ray_shuffling_data_loader_tpu/ops/flash_attention.py"

MAIN_SHAPE = (65536, 19, 32)
RESIDENT_SHAPE = (250000, 19, 32)  # the DLRM's at the resident phase's batch
POD_SHAPE = (16384, 19, 32)  # the DLRM's at a pod rank's shard of the global batch 65536
RAGGED_SHAPE = (500, 27, 16)
# The tensor-core route of K1: the DLRM's shape, a batch ragged against its
# 8-sample tile, (500, 27, 16) (16-sample tiles, an odd pair count), N = 64
# and D = 128 (MLPerf DLRM's 26 tables + the dense row at width 128).
INTERACTION_MMA_SHAPES = (MAIN_SHAPE, RESIDENT_SHAPE, POD_SHAPE, (1001, 19, 32), RAGGED_SHAPE, (4096, 64, 64),
                          (8192, 27, 128))
# bf16: kernel and plain version both sum in fp32 and round once to bf16,
# so a different summation order can move a result by at most one bf16
# step, which is at most 2**-7 of its value. Summing in bf16, or rounding
# twice, errs by several steps and fails.
BF16_TOL = dict(atol=1e-3, rtol=2**-7)
# fp32: the same 16-term dot products summed in another order.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# Parity: the same fp32 module on two devices, TF32 off; the interaction,
# the attention and the matmuls sum in other orders (K up to 779).
PARITY_TOL = dict(atol=1e-4, rtol=1e-4)

# Flash attention: (name, [b, t, h, hd], dtype, causal).
TAB_SHAPE = (65536, 19, 4, 8)
LM_SHAPE = (4, 512, 4, 16)
LONG_SHAPE = (2, 4096, 8, 64)  # benchmarks/bench_attention.py's default
# The flash kernels' shapes on the sp phase's trainer (the CausalLM's
# [4, 512, 4, 16] over dp 2 x sp 4): a ring hop's block, and the whole
# sequence of one head in the Ulysses body.
SP_RING_HOP_SHAPE = (2, 128, 4, 16)
SP_ULYSSES_SHAPE = (2, 512, 1, 16)
FLASH_CASES = (
    ("tabtransformer", TAB_SHAPE, "bfloat16", False),
    ("causal_lm", LM_SHAPE, "bfloat16", True),
    ("ragged", (1, 300, 2, 8), "float32", True),
    ("short", (2, 56, 2, 8), "float32", False),
    # The wider head-dim buckets (2 and 8 lanes per row) and a head dim
    # that fills no 16-byte vector (element loads).
    ("wide_heads", (2, 200, 2, 64), "bfloat16", True),
    ("max_head_dim", (1, 70, 3, 120), "float32", False),
    ("unaligned", (3, 5, 2, 20), "bfloat16", False),
    # The tensor-core route: the long shape, and head dims of 2 to 8
    # k-steps (32, 80, 96, 128) with t ragged against the 64-row tiles.
    ("long", LONG_SHAPE, "bfloat16", False),
    ("long_causal", LONG_SHAPE, "bfloat16", True),
    ("hd32_ragged", (2, 333, 3, 32), "bfloat16", False),
    ("hd80_ragged", (1, 77, 2, 80), "bfloat16", True),
    ("hd96_ragged", (1, 100, 2, 96), "bfloat16", False),
    ("hd128_ragged", (1, 157, 2, 128), "bfloat16", True),
)
# The route sweep that chose T_MIN: the CausalLM's batch and heads.
SWEEP_T = (32, 64, 128, 256)
SWEEP_HD = (16, 64)
# Flash tolerances. fp32: the order of tests/test_flash_attention.py (2e-5
# forward, 1e-4 gradients): kernel and plain version take the same fp32
# products and sum them in another order, and the kernel rescales its
# running sums once per chunk of keys where the plain version normalises
# once. m and l are fp32 in both dtypes: m is a max of the same scores
# (one fp32 rounding apart), l a sum of at most t exponentials of them.
# bf16: both compute in fp32 from the same bf16 inputs and round each
# output once, so they may differ by one bf16 step (2**-7 of the value);
# the atol covers values near 0, whose step is smaller than the fp32
# summation error of their O(1) terms.
FLASH_TOL = {
    "float32": {"out": dict(atol=2e-5, rtol=2e-5), "grad": dict(atol=1e-4, rtol=1e-4)},
    "bfloat16": {"out": dict(atol=1e-5, rtol=2**-7), "grad": dict(atol=1e-4, rtol=2**-7)},
}
STATS_TOL = dict(atol=1e-5, rtol=2e-5)

# Device-memory rate of the H100 SXM (NVIDIA data sheet), bytes/s; another
# card's bounds use the rate of a device-to-device copy measured here.
H100_SXM_NAME = "H100 80GB HBM3"
H100_SXM_RATE = 3.35e12
BF16_PEAK = 989e12  # dense tensor-core rate, H100 SXM at 700 W
# About 10 ms at the H100's 1.98 GHz: time for the host to queue 50 calls
# of a wrapper that takes up to 200 us on the host.
SPIN_CYCLES = 20_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate(torch, name: str):
    """``(bytes/s used for bounds, its source, measured copy rate)``."""
    n = 1 << 28  # 1 GiB of fp32
    a = torch.empty(n, device="cuda")
    b = torch.empty_like(a)
    for _ in range(3):
        b.copy_(a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    reps = 10
    for _ in range(reps):
        b.copy_(a)
    end.record()
    torch.cuda.synchronize()
    measured = 2 * a.numel() * 4 * reps / (start.elapsed_time(end) / 1e3)
    del a, b
    if H100_SXM_NAME in name:
        return H100_SXM_RATE, f"data sheet ({H100_SXM_NAME})", measured
    return measured, "device-to-device copy", measured


def time_ms(torch, fn, *args, reps: int = 50) -> float:
    """Device ms per call of ``fn(*args)``. The card first spins for
    SPIN_CYCLES, while the host queues all ``reps`` calls, so a kernel
    shorter than its wrapper's host time is timed on the card, not at the
    host's launch rate."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, rate: float, peak: float):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    bytes_ms = nbytes / rate * 1e3
    ops_ms = ops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


LAUNCH_COUNTED = ("interaction_kernel", "flash_fwd_kernel", "flash_bwd_dkv_kernel",
                  "flash_bwd_dq_kernel")


def reset_launches(ops) -> None:
    for name in LAUNCH_COUNTED:
        fn = getattr(ops, name)
        fn.launches = fn.mma_launches = 0


def read_launches(ops) -> dict:
    """Launches per kernel: ``interaction``, ``flash_fwd`` etc. count both
    routes, ``*_mma`` the tensor-core route alone."""
    counts = {}
    for name in LAUNCH_COUNTED:
        fn = getattr(ops, name)
        key = name.removesuffix("_kernel")
        counts[key] = fn.launches
        counts[f"{key}_mma"] = fn.mma_launches
    return counts


def phase_build():
    from ray_shuffling_data_loader_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = pool.map(_build.build, KERNEL_SOURCES)
        # While nvcc runs, what this process's first Adam would import (its
        # builder threads import nothing of torch).
        import torch._dynamo  # noqa: F401
        import torch._inductor  # noqa: F401

        paths = dict(zip(KERNEL_SOURCES, built))
    log(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, path in paths.items():
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}")
        # ptxas -v: an entry's name, then its spills, then its registers.
        entry = spills = None
        for line in _build.build_log(name).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            elif "spill stores" in line:
                spills = line.strip()
            elif "registers" in line and entry:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                log(f"[build] {name}: {entry}: {regs} registers; {spills}")
                entry = spills = None


# The port's reviewed lint suppressions (tests/test_torch_port_lint.py pins
# the same count): a new one is a reviewed change of this number.
LINT_SUPPRESSED = 26
# The runtime twin of gate-integrity: the core imports with CUDA present,
# then no light gated plane may be loaded. A file, for the pool's spawn.
GATE_PROBE = """\
import json, os, sys
for k in list(os.environ):
    if k.startswith("RSDL_"):
        del os.environ[k]


def main():
    import torch
    from ray_shuffling_data_loader_tpu_torch import dataset, device_dataset, runtime, shuffle, telemetry  # noqa: F401
    from ray_shuffling_data_loader_tpu_torch.runtime import actor  # noqa: F401

    assert telemetry.outbound() is None
    torch.ones(1, device="cuda").sum().item()
    runtime.init(num_workers=1)
    assert runtime.submit(len, [1, 2, 3]).result(timeout=120) == 3
    runtime.shutdown()
    gated = [m for m in sys.modules
             if m.endswith((".telemetry.trace", ".telemetry.audit", ".telemetry.export", ".runtime.faults"))]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "gated": gated}))


if __name__ == "__main__":
    main()
"""
GATE_PROBE_PATH = os.path.join(ROOT, "build", "gate_probe.py")


def _seconds(fn, *args) -> tuple:
    """``(fn(*args), its wall seconds)``."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def _run_gate_probe() -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run([sys.executable, GATE_PROBE_PATH], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


def start_lint(pool) -> tuple:
    """Start the port's lint (``--json``, as a user runs it) and the gate
    probe in ``pool``, each in a process of its own with every ``RSDL_*``
    unset, while the build runs."""
    os.makedirs(os.path.dirname(GATE_PROBE_PATH), exist_ok=True)
    with open(GATE_PROBE_PATH, "w") as f:
        f.write(GATE_PROBE)
    return pool.submit(_seconds, run_tool, "rsdl_lint", "--json"), pool.submit(_seconds, _run_gate_probe)


def phase_lint(lint, probe) -> dict:
    """Wait for :func:`start_lint`'s processes and check them."""
    try:
        ((rc, out, err), lint_s), (pres, probe_s) = lint.result(), probe.result()
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(GATE_PROBE_PATH)
    if rc != 0:
        raise AssertionError(f"[lint] rsdl_lint exited {rc}: {out[-3000:]}{err[-2000:]}")
    payload = json.loads(out)
    unreasoned = [f for f in payload["findings"] if not (f.get("suppressed") and f.get("suppress_reason"))]
    if payload["counts"] != {"active": 0, "suppressed": LINT_SUPPRESSED} or unreasoned:
        raise AssertionError(f"[lint] counts {payload['counts']}, want 0 active and {LINT_SUPPRESSED} suppressed; "
                             f"without a reason: {unreasoned}")
    if pres.returncode != 0:
        raise AssertionError(f"[lint] gate probe exited {pres.returncode}: {pres.stdout[-2000:]}{pres.stderr[-3000:]}")
    got = json.loads(pres.stdout.strip().splitlines()[-1])
    if got["gated"]:
        raise AssertionError(f"[lint] gate probe: gated planes loaded with every RSDL_* unset: {got['gated']}")
    by_check: dict = {}
    for f in payload["findings"]:
        by_check[f["check"]] = by_check.get(f["check"], 0) + 1
    log(f"[lint] rsdl_lint --json: exit 0, {payload['counts']['active']} active, "
        f"{payload['counts']['suppressed']} suppressed {by_check}, {lint_s:.2f} s; gate probe on "
        f"{got['device']}: core imports, runtime.init, submit, shutdown, no gated plane loaded, {probe_s:.2f} s")
    return {"exit": rc, "counts": payload["counts"], "suppressed_by_check": by_check,
            "lint_s": lint_s, "probe_s": probe_s, "probe_device": got["device"]}


# The host kernels' shapes: the map of one Quick-start file (100,000 rows,
# 21 columns, 8 reducers), one reducer's take over 8 parts (125,000 rows),
# one file of the resident phase (744,048 rows) and the probe's 8 M rows.
QUICK_FILE_ROWS, QUICK_COLUMNS, QUICK_REDUCERS = 100_000, 21, 8
REDUCER_PARTS, REDUCER_ROWS = 8, 125_000
RESIDENT_FILE_ROWS = 744_048
PROBE_ROWS = (64 << 20) // 8
HOST_KERNELS = "ray_shuffling_data_loader_tpu_torch/native/kernels.cc"


def host_copy_rate(np) -> float:
    """Bytes/s (read plus write) of ``np.copyto`` between two 512 MiB
    buffers, best of 3: the host's memory rate, the host kernels' bound."""
    src = np.arange(64 << 20, dtype=np.int64)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2 * src.nbytes / best


def best_s(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_native() -> dict:
    """Build the host kernels (``native/kernels.cc``, g++), hold every entry
    point against its plain numpy version, bit for bit, at the shapes the
    shuffle gives it, time both against the host's copy rate, and read the
    schedule policy's probe with the kernels on and off."""
    import numpy as np

    from ray_shuffling_data_loader_tpu_torch import native
    from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

    t0 = time.perf_counter()
    path = native.build()
    native.load()
    build_s = time.perf_counter() - t0
    log(f"[native] built {os.path.relpath(path, ROOT)} from {HOST_KERNELS} in {build_s:.2f} s "
        f"(g++ {' '.join(native.CXX_FLAGS)}); default {native.num_threads()} threads on {os.cpu_count()} cores")
    copy_rate = host_copy_rate(np)
    log(f"[native] host copy rate {copy_rate / 1e9:.4g} GB/s (read + write, np.copyto of 512 MiB, best of 3)")
    rng = np.random.default_rng(0)

    def threads_for(n, group=False):
        cap = max(1, n // native._MIN_ROWS_PER_THREAD) if group else (n >> 19 if n >= 1 << 14 else 1)
        return max(1, min(native.num_threads(), cap))

    def cols_of(n, dtype):
        return {f"c{i}": rng.integers(0, 1 << 30, size=n).astype(dtype) for i in range(QUICK_COLUMNS)}

    cases = []

    def case(label, kernel, n, threads, nbytes, run, plain):
        got, want = run(), plain()
        if not same_bits(got, want):
            raise AssertionError(f"[native] {label}: {kernel} differs from its numpy version")
        t_native, t_plain = best_s(run), best_s(plain)
        row = {"label": label, "kernel": kernel, "rows": n, "threads": threads, "bytes": nbytes,
               "native_ms": t_native * 1e3, "plain_ms": t_plain * 1e3,
               "native_gbs": nbytes / t_native / 1e9, "plain_gbs": nbytes / t_plain / 1e9,
               "bound_ms": nbytes / copy_rate * 1e3}
        cases.append(row)
        log(f"[native] {label}: {kernel}, {n} rows, {threads} thread(s), {nbytes} B: native {row['native_ms']!r} ms "
            f"({row['native_gbs']:.4g} GB/s), numpy {row['plain_ms']!r} ms ({row['plain_gbs']:.4g} GB/s), "
            f"bound {row['bound_ms']!r} ms at the copy rate; bit-equal")

    # The map of one Quick-start file: narrowing, then the group-by scatter.
    wide = cols_of(QUICK_FILE_ROWS, np.int64)
    wide["labels"] = rng.random(QUICK_FILE_ROWS)
    n = QUICK_FILE_ROWS
    case("quick map: narrow", "narrow", n, threads_for(n), sum(v.nbytes * 3 // 2 for v in wide.values()),
         lambda: [native.narrow_i64_checked(v) if v.dtype == np.int64 else native.narrow(v, np.float32)
                  for v in wide.values()],
         lambda: [native.narrow_i64_checked_plain(v) if v.dtype == np.int64 else native.narrow_plain(v, np.float32)
                  for v in wide.values()])
    narrow_cols = cols_of(n, np.int32)
    assignment = rng.integers(QUICK_REDUCERS, size=n)
    out = {k: np.empty_like(v) for k, v in narrow_cols.items()}
    case("quick map: group-by", "group_rows", n, threads_for(n, True),
         2 * sum(v.nbytes for v in narrow_cols.values()) + assignment.nbytes,
         lambda: native.group_rows_multi(narrow_cols, assignment, QUICK_REDUCERS, out=out),
         lambda: native.group_rows_multi_plain(narrow_cols, assignment, QUICK_REDUCERS))
    # One reducer: its 8 parts gathered in one pass, and the index
    # schedule's permutation of a compact column.
    part = REDUCER_ROWS // REDUCER_PARTS
    parts = {k: [v[i * part:(i + 1) * part] for i in range(REDUCER_PARTS)]
             for k, v in cols_of(REDUCER_ROWS, np.int32).items()}
    perm = rng.permutation(REDUCER_ROWS)
    per_col = 2 * REDUCER_ROWS * 4 + perm.nbytes
    dst = {k: np.empty(REDUCER_ROWS, np.int32) for k in parts}
    case("reducer: concat-gather", "take_multi", REDUCER_ROWS, threads_for(REDUCER_ROWS), QUICK_COLUMNS * per_col,
         lambda: {k: native.take_multi(p, perm, out=dst[k]) for k, p in parts.items()},
         lambda: {k: native.take_multi_plain(p, perm) for k, p in parts.items()})
    compact = {k: np.concatenate(p) for k, p in parts.items()}
    case("reducer: permute", "take", REDUCER_ROWS, threads_for(REDUCER_ROWS), QUICK_COLUMNS * per_col,
         lambda: {k: native.take(v, perm, out=dst[k]) for k, v in compact.items()},
         lambda: {k: native.take_plain(v, perm) for k, v in compact.items()})
    # One resident-shape file.
    n = RESIDENT_FILE_ROWS
    res_cols = cols_of(n, np.int32)
    res_asg = rng.integers(QUICK_REDUCERS, size=n)
    res_out = {k: np.empty_like(v) for k, v in res_cols.items()}
    case("resident file: group-by", "group_rows", n, threads_for(n, True),
         2 * sum(v.nbytes for v in res_cols.values()) + res_asg.nbytes,
         lambda: native.group_rows_multi(res_cols, res_asg, QUICK_REDUCERS, out=res_out),
         lambda: native.group_rows_multi_plain(res_cols, res_asg, QUICK_REDUCERS))
    res_perm = rng.permutation(n)
    col = res_cols["c0"]
    scattered = np.empty_like(col)
    case("resident file: scatter", "scatter", n, threads_for(n), 2 * col.nbytes + res_perm.nbytes,
         lambda: native.scatter(col, res_perm, scattered),
         lambda: native.scatter_plain(col, res_perm, np.empty_like(col)))
    # The probe's 8 M rows: a random and a sequential gather, the scatter
    # and the group-by where every kernel runs threaded.
    n = PROBE_ROWS
    buf = np.arange(n, dtype=np.int64)
    for label, idx in (("probe: random gather", rng.permutation(n)), ("probe: sequential gather", np.arange(n))):
        case(label, "take", n, threads_for(n), 2 * buf.nbytes + idx.nbytes,
             lambda idx=idx: native.take(buf, idx), lambda idx=idx: native.take_plain(buf, idx))
    big_perm = rng.permutation(n)
    big_out = np.empty_like(buf)
    case("probe size: scatter", "scatter", n, threads_for(n), 2 * buf.nbytes + big_perm.nbytes,
         lambda: native.scatter(buf, big_perm, big_out),
         lambda: native.scatter_plain(buf, big_perm, np.empty_like(buf)))
    big_asg = rng.integers(QUICK_REDUCERS, size=n)
    case("probe size: group-by", "group_rows", n, threads_for(n, True), 2 * buf.nbytes + big_asg.nbytes,
         lambda: native.group_rows_multi({"k": buf}, big_asg, QUICK_REDUCERS),
         lambda: native.group_rows_multi_plain({"k": buf}, big_asg, QUICK_REDUCERS))
    case("probe size: narrow", "narrow", n, threads_for(n), buf.nbytes * 3 // 2,
         lambda: native.narrow_i64_checked(buf), lambda: native.narrow_i64_checked_plain(buf))
    # The schedule policy's probe as ``shuffle()``'s process takes it, with the kernels
    # on (the default) and off (the numpy the port timed before).
    probes = {}
    port_runtime.init()
    try:
        for label, flag in (("native", True), ("numpy", False)):
            native.set_enabled(flag)
            try:
                port_shuffle._PROBE_CACHE.pop("costs", None)
                probes[label] = port_shuffle._probed_host_costs()
            finally:
                native.set_enabled(None)
                port_shuffle._PROBE_CACHE.pop("costs", None)
            log(f"[native] probe ({label}): " + ", ".join(f"{k} {v!r}" for k, v in probes[label].items()))
    finally:
        port_runtime.shutdown()
    return {"build_s": build_s, "copy_rate": copy_rate, "cases": cases, "probe": probes,
            "threads": native.num_threads(), "cores": os.cpu_count()}


def phase_interaction(torch, rate: float, rate_src: str) -> list:
    """K1 on both routes against the plain version, then both timed at the
    DLRM's shape: the ``interaction`` (CUDA-core) and ``interaction_mma``
    (tensor-core) entries of the kernels line."""
    from ray_shuffling_data_loader_tpu_torch.ops.interaction import (
        dot_interaction_reference,
        interaction_kernel,
        interaction_route,
        num_pairs,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def embeddings(shape, dtype):
        # Embedding-like values: the model's tables start at std 1/sqrt(D).
        return (torch.randn(shape, device="cuda", generator=gen) / shape[2] ** 0.5).to(dtype)

    errs = {}
    cases = [("mma", shape, torch.bfloat16, BF16_TOL) for shape in INTERACTION_MMA_SHAPES]
    cases += [("simt", MAIN_SHAPE, torch.bfloat16, BF16_TOL), ("simt", RAGGED_SHAPE, torch.float32, FP32_TOL)]
    for route, shape, dtype, tol in cases:
        x = embeddings(shape, dtype)
        got = interaction_kernel(x, route)
        torch.cuda.synchronize()
        want = dot_interaction_reference(x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[route, shape] = err
        log(f"[kernel] interaction ({route}) {shape} {dtype}: max |kernel - plain| = {err!r} "
            f"(atol {tol['atol']}, rtol {tol['rtol']}; default route {interaction_route(x)})")
    if interaction_route(embeddings(MAIN_SHAPE, torch.bfloat16)) != "mma":
        raise AssertionError("interaction: the DLRM's shape does not take the tensor-core route")

    b, n, d = MAIN_SHAPE
    x = embeddings(MAIN_SHAPE, torch.bfloat16)
    iu, ju = torch.triu_indices(n, n, 1, device="cuda")
    ms = {route: time_ms(torch, interaction_kernel, x, route) for route in ("simt", "mma")}
    plain_ms = time_ms(torch, dot_interaction_reference, x)
    # A yardstick, not a library call for K1: the whole bf16 Gram by bmm,
    # then the triangle gathered (two calls, and N^2 outputs, not N(N-1)/2).
    bmm_ms = time_ms(torch, lambda: torch.bmm(x, x.transpose(1, 2))[:, iu, ju])
    nbytes = b * n * d * 2 + b * num_pairs(n) * 2
    ops = 2 * b * num_pairs(n) * d
    bound_ms, bound_by = bound(nbytes, ops, rate, BF16_PEAK)
    log(f"[kernel] interaction {MAIN_SHAPE} bf16: mma {ms['mma']!r} ms, simt {ms['simt']!r} ms, "
        f"plain {plain_ms!r} ms, bmm + gather {bmm_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
        f"({nbytes} B at {rate:.4g} B/s from {rate_src}; {ops} ops at bf16 peak)")
    rb, rn, rd = RESIDENT_SHAPE
    xr = embeddings(RESIDENT_SHAPE, torch.bfloat16)
    r_bytes, r_ops = rb * rn * rd * 2 + rb * num_pairs(rn) * 2, 2 * rb * num_pairs(rn) * rd
    r_bound, r_by = bound(r_bytes, r_ops, rate, BF16_PEAK)
    log(f"[kernel] interaction {RESIDENT_SHAPE} bf16 (the resident phase's): mma "
        f"{time_ms(torch, interaction_kernel, xr, 'mma')!r} ms, plain {time_ms(torch, dot_interaction_reference, xr)!r} "
        f"ms, bound {r_bound!r} ms by {r_by} ({r_bytes} B)")
    pb, pn, pd = POD_SHAPE
    xp = embeddings(POD_SHAPE, torch.bfloat16)
    p_bytes, p_ops = pb * pn * pd * 2 + pb * num_pairs(pn) * 2, 2 * pb * num_pairs(pn) * pd
    p_bound, p_by = bound(p_bytes, p_ops, rate, BF16_PEAK)
    p_mma, p_plain = time_ms(torch, interaction_kernel, xp, "mma"), time_ms(torch, dot_interaction_reference, xp)
    log(f"[kernel] interaction {POD_SHAPE} bf16 (a pod rank's shard): mma {p_mma!r} ms, plain {p_plain!r} ms, "
        f"bound {p_bound!r} ms by {p_by} ({p_bytes} B)")
    return [
        {
            "name": name,
            "route": "cuda",
            "source": CSRC + source,
            "replaces": "ray_shuffling_data_loader_tpu/ops/interaction.py:68",
            "launches": None,
            "max_abs_err": errs[route, MAIN_SHAPE],
            "ms": ms[route],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # No single PyTorch call computes the strict upper triangle of
            # a batched Gram (bmm plus a gather is two).
            "library_ms": None,
        }
        for name, route, source in (("interaction", "simt", "interaction.cu"),
                                    ("interaction_mma", "mma", "interaction_mma.cu"))
    ]


def flash_inputs(torch, shape, dtype, gen):
    """``qkv`` ``[b, t, 3, h, hd]`` and a cotangent dO, as the encoder block
    gives them to the Function; q, k and v are its strided views."""
    b, t, h, hd = shape
    qkv = torch.randn((b, t, 3, h, hd), device="cuda", generator=gen).to(dtype)
    dout = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return qkv, dout


def packed_grads(torch, qkv):
    """dq, dk, dv as views of one packed gradient, as the Function's
    backward writes them; NaN until a kernel writes them."""
    return torch.full_like(qkv, float("nan")).unbind(2)


def flash_work(shape, elem: int, causal: bool):
    """Bytes each flash kernel must move (inputs read once, outputs written
    once) and the multiply-adds x 2 its products need, per kernel."""
    b, t, h, hd = shape
    tensor = b * t * h * hd * elem
    row = b * h * t * 4
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return {
        "flash_fwd": (3 * tensor + tensor + 2 * row, 4 * pairs * hd),
        "flash_bwd_dkv": (4 * tensor + 3 * row + 2 * tensor, 8 * pairs * hd),
        "flash_bwd_dq": (4 * tensor + 3 * row + tensor, 6 * pairs * hd),
    }


def compare(torch, label: str, pairs) -> dict:
    """Hold each ``(key, got, want, tol)`` within ``tol``; returns the max
    absolute differences."""
    errs = {}
    for key, got, want, tol in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{label} {key}: {got.dtype} {tuple(got.shape)}, "
                                 f"want {want.dtype} {tuple(want.shape)}")
        errs[key] = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda s: f"{label} {key}: {s}")
    return errs


def check_flash(torch, ops, case, gen) -> dict:
    """K2, K3 and K4 against the plain versions on every route that takes
    the case (``errors[route]``), then the autograd Function on
    the default route (``errors["function"]``)."""
    name, shape, dtype_name, causal = case
    dtype = getattr(torch, dtype_name)
    qkv, dout = flash_inputs(torch, shape, dtype, gen)
    q, k, v = qkv.unbind(2)
    default = ops.flash_route(q, k, v)
    routes = ops.ROUTES if ops.mma_supported(q, k, v) else ("simt",)
    out_r, m_r, l_r = ops.flash_forward_reference(q, k, v, causal)
    tol = FLASH_TOL[dtype_name]
    errs = {"route": default}
    for route in routes:
        dq, dk, dv = packed_grads(torch, qkv)
        out, m, l = ops.flash_fwd_kernel(q, k, v, causal, route)
        big_d = ops.row_dot(dout, out)
        ops.flash_bwd_dkv_kernel(q, k, v, dout, m, l, big_d, dk, dv, causal, route)
        ops.flash_bwd_dq_kernel(q, k, v, dout, m, l, big_d, dq, causal, route)
        torch.cuda.synchronize()
        grads_r = ops.flash_backward_reference(q, k, v, out, m, l, dout, causal)
        errs[route] = compare(torch, f"{name} ({route})", (
            ("out", out, out_r, tol["out"]), ("m", m, m_r, STATS_TOL), ("l", l, l_r, STATS_TOL),
            *((key, got, want, tol["grad"]) for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_r)),
        ))
        if route == default:
            default_grads_r = grads_r
    # The Function as the encoder block calls it (the default route): its
    # packed gradient must hold the same dQ, dK, dV at the right places.
    leaf = qkv.detach().requires_grad_(True)
    fn_out = ops.flash_attention_qkv(leaf, causal)
    fn_out.backward(dout)
    torch.cuda.synchronize()
    errs["function"] = compare(torch, f"{name} (function)", (
        ("out", fn_out, out_r, tol["out"]),
        ("dqkv", leaf.grad, torch.stack(default_grads_r, dim=2), tol["grad"]),
    ))
    log(f"[kernel] flash {name} {list(shape)} {dtype_name} causal={causal}, route {default} "
        f"(checked: {', '.join(routes)}): max |kernel - plain| "
        + "; ".join(f"{r}: " + ", ".join(f"{k_} {e!r}" for k_, e in errs[r].items())
                    for r in (*routes, "function"))
        + f" (out {tol['out']}, m/l {STATS_TOL}, grads {tol['grad']})")
    return errs


def time_flash(torch, ops, shape, causal, rate, gen) -> dict:
    """Each flash kernel, its plain version and the library call, in bf16
    at ``shape``: ``{kernel: {ms, plain_ms, library_ms, bound_ms, ...}}``.
    ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` are the CUDA-core
    route; where the tensor-core route takes the shape, the ``*_mma``
    kernels are timed beside them in the same call."""
    import torch.nn.functional as F

    qkv, dout = flash_inputs(torch, shape, torch.bfloat16, gen)
    q, k, v = qkv.unbind(2)
    dq, dk, dv = packed_grads(torch, qkv)
    out, m, l = ops.flash_fwd_kernel(q, k, v, causal)
    big_d = ops.row_dot(dout, out)
    routes = ops.ROUTES if ops.mma_supported(q, k, v) else ("simt",)
    fwd_ms, dkv_ms, dq_ms = {}, {}, {}
    for route in routes:
        fwd_ms[route] = time_ms(torch, ops.flash_fwd_kernel, q, k, v, causal, route)
        dkv_ms[route] = time_ms(torch, ops.flash_bwd_dkv_kernel, q, k, v, dout, m, l, big_d, dk, dv,
                                causal, route)
        dq_ms[route] = time_ms(torch, ops.flash_bwd_dq_kernel, q, k, v, dout, m, l, big_d, dq,
                               causal, route)
    reps = 10 if shape[1] > 1024 else 50
    plain_fwd_ms = time_ms(torch, ops.flash_forward_reference, q, k, v, causal, reps=reps)
    plain_bwd_ms = time_ms(torch, ops.flash_backward_reference, q, k, v, out, m, l, dout, causal,
                           reps=reps)
    # scaled_dot_product_attention takes [batch, heads, t, hd]; the
    # transposes are made once, outside the timed call. Its kernels put
    # batch and heads on grid axes of at most 65,535 blocks, so the b*h
    # independent heads are regrouped as [b*h / n, n, t, hd], n = gcd(b*h,
    # 4096). Its forward computes K2's output (not the statistics); its
    # backward through autograd K3's and K4's together.
    # cuDNN's backend fails at the TabTransformer's 262,144 heads, so the
    # call is held to PyTorch's flash and memory-efficient backends.
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, t, h, hd = shape
    heads = math.gcd(b * h, 4096)

    def regroup(x):
        return x.transpose(1, 2).reshape(b * h // heads, heads, t, hd)

    qt, kt, vt = (regroup(x).detach().requires_grad_(True) for x in (q, k, v))
    dot = regroup(dout)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        sdpa_fwd_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        )
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        sdpa_bwd_ms = time_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)
        )
    work = flash_work(shape, 2, causal)
    times = {
        "flash_fwd": (fwd_ms["simt"], plain_fwd_ms, sdpa_fwd_ms),
        "flash_bwd_dkv": (dkv_ms["simt"], plain_bwd_ms, sdpa_bwd_ms),
        "flash_bwd_dq": (dq_ms["simt"], plain_bwd_ms, sdpa_bwd_ms),
    }
    if "mma" in routes:
        times["flash_fwd_mma"] = (fwd_ms["mma"], plain_fwd_ms, sdpa_fwd_ms)
        times["flash_bwd_dkv_mma"] = (dkv_ms["mma"], plain_bwd_ms, sdpa_bwd_ms)
        times["flash_bwd_dq_mma"] = (dq_ms["mma"], plain_bwd_ms, sdpa_bwd_ms)
    result = {}
    for kname, (ms, plain_ms, lib_ms) in times.items():
        nbytes, nops = work[kname.removesuffix("_mma")]
        bound_ms, bound_by = bound(nbytes, nops, rate, BF16_PEAK)
        result[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=nbytes, ops=nops)
        log(f"[kernel] {kname} {list(shape)} bf16 causal={causal}: kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms, sdpa {lib_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
            f"({nbytes} B, {nops} ops)")
    return result


def route_sweep(torch, ops, gen) -> list:
    """Both routes of K2, K3 and K4 at ``[4, t, 4, hd]`` bf16 causal (the
    CausalLM's batch and heads), where ``T_MIN`` was chosen."""
    rows = []
    for hd in SWEEP_HD:
        for t in SWEEP_T:
            shape = (4, t, 4, hd)
            qkv, dout = flash_inputs(torch, shape, torch.bfloat16, gen)
            q, k, v = qkv.unbind(2)
            dq, dk, dv = packed_grads(torch, qkv)
            out, m, l = ops.flash_fwd_kernel(q, k, v, True, "simt")
            big_d = ops.row_dot(dout, out)
            row = {"shape": list(shape)}
            for route in ops.ROUTES:
                row[f"fwd_{route}_ms"] = time_ms(torch, ops.flash_fwd_kernel, q, k, v, True, route)
                row[f"dkv_{route}_ms"] = time_ms(torch, ops.flash_bwd_dkv_kernel, q, k, v, dout, m,
                                                 l, big_d, dk, dv, True, route)
                row[f"dq_{route}_ms"] = time_ms(torch, ops.flash_bwd_dq_kernel, q, k, v, dout, m,
                                                l, big_d, dq, True, route)
            log(f"[kernel] route sweep {shape} bf16 causal: K2 mma {row['fwd_mma_ms']!r} ms, "
                f"simt {row['fwd_simt_ms']!r} ms; K3 mma {row['dkv_mma_ms']!r} ms, "
                f"simt {row['dkv_simt_ms']!r} ms; K4 mma {row['dq_mma_ms']!r} ms, "
                f"simt {row['dq_simt_ms']!r} ms (T_MIN {ops.T_MIN}: route "
                f"{ops.flash_route(q, k, v)})")
            rows.append(row)
    return rows


def phase_flash(torch, rate: float):
    import ray_shuffling_data_loader_tpu_torch.ops as ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    # One bf16 shape on each side of T_MIN.
    cases = (*FLASH_CASES, ("below_t_min", (4, ops.T_MIN - 1, 4, 16), "bfloat16", True),
             ("at_t_min", (4, ops.T_MIN, 4, 16), "bfloat16", True))
    errs = {case[0]: check_flash(torch, ops, case, gen) for case in cases}
    for name, want in (("tabtransformer", "simt"), ("causal_lm", "mma"), ("below_t_min", "simt"),
                       ("at_t_min", "mma"), ("long", "mma")):
        if errs[name]["route"] != want:
            raise AssertionError(f"flash {name}: route {errs[name]['route']}, want {want}")
    timings = {
        "tabtransformer": time_flash(torch, ops, TAB_SHAPE, False, rate, gen),
        "causal_lm": time_flash(torch, ops, LM_SHAPE, True, rate, gen),
        "long": time_flash(torch, ops, LONG_SHAPE, False, rate, gen),
        "long_causal": time_flash(torch, ops, LONG_SHAPE, True, rate, gen),
        "sp_ring_hop": time_flash(torch, ops, SP_RING_HOP_SHAPE, False, rate, gen),
        "sp_ring_hop_causal": time_flash(torch, ops, SP_RING_HOP_SHAPE, True, rate, gen),
        "sp_ulysses": time_flash(torch, ops, SP_ULYSSES_SHAPE, True, rate, gen),
    }
    sweep = route_sweep(torch, ops, gen)
    tab_err = errs["tabtransformer"]["simt"]
    lm_err = errs["causal_lm"]["mma"]
    entries = []
    for kname, line, err, source, cell in (
        ("flash_fwd", 50, max(tab_err["out"], tab_err["m"], tab_err["l"]), "flash_fwd.cu",
         "tabtransformer"),
        ("flash_bwd_dkv", 252, max(tab_err["dk"], tab_err["dv"]), "flash_bwd.cu", "tabtransformer"),
        ("flash_bwd_dq", 331, tab_err["dq"], "flash_bwd.cu", "tabtransformer"),
        ("flash_fwd_mma", 50, max(lm_err["out"], lm_err["m"], lm_err["l"]), "flash_fwd_mma.cu",
         "causal_lm"),
        ("flash_bwd_dkv_mma", 252, max(lm_err["dk"], lm_err["dv"]), "flash_bwd_dkv_mma.cu",
         "causal_lm"),
        ("flash_bwd_dq_mma", 331, lm_err["dq"], "flash_bwd_dq_mma.cu", "causal_lm"),
    ):
        t = timings[cell][kname]
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": CSRC + source,
            "replaces": f"{JAX_FLASH}:{line}",
            "launches": None,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    return entries, {"errors": errs, "timings": timings, "route_sweep": sweep}


def delivery_report(port, ds, filenames, label: str) -> dict:
    """Log how a finished ``DeviceShufflingDataset`` run delivered: each
    epoch's schedule and shuffle seconds, the resolved ``cache_decoded``,
    the decoded-size estimate against the store's budget, the host probe's
    figures, direct and carried batches with the host time each kind took
    to stage, the staging stall and the store's peak."""
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

    host, st = ds.dataset, ds.stats
    out = {
        "schedules": [s for _, s in host.schedule_log],
        "epoch_shuffle_s": host.shuffle_stats.get("epoch_shuffle_s"),
        "cache_decoded": host.shuffle_stats.get("cache_decoded"),
        "est_decoded_bytes": port_shuffle._est_decoded_bytes(list(filenames), True),
        "capacity_bytes": port.runtime.get_context().store.capacity_bytes,
        "probe": port_shuffle._PROBE_CACHE.get("costs"),
        "batches_direct": st.batches_direct,
        "batches_carried": st.batches_carried,
        "put_dispatch_direct_ms": st.put_dispatch_direct_s / max(1, st.batches_direct) * 1e3,
        "put_dispatch_carried_ms": (st.put_dispatch_s - st.put_dispatch_direct_s) / max(1, st.batches_carried) * 1e3,
        "stall_staging_s": st.stall_staging_s,
        "store_peak_bytes": host.shuffle_stats.get("store_peak_bytes"),
        "plan": host.shuffle_stats.get("plan"),
        "selective_reads": host.shuffle_stats.get("selective_reads"),
        "native_calls": host.shuffle_stats.get("native_calls"),
        "plain_calls": host.shuffle_stats.get("plain_calls"),
        "selective_rowgroups": {e: sorted(map(tuple, g))
                                for e, g in host.shuffle_stats.get("selective_rowgroups", {}).items()},
    }
    log(f"[{label}] plan {out['plan']}; selective reads: {out['selective_reads']}; host kernel calls "
        f"native {out['native_calls']}, numpy {out['plain_calls']}")
    log(f"[{label}] schedules {out['schedules']}, shuffle {out['epoch_shuffle_s']!r} s per epoch; "
        f"cache_decoded {out['cache_decoded']} (estimate {out['est_decoded_bytes']!r} B against capacity "
        f"{out['capacity_bytes']} B); probe {out['probe']}; batches {out['batches_direct']} direct, "
        f"{out['batches_carried']} carried; put_dispatch {out['put_dispatch_direct_ms']!r} ms per direct batch, "
        f"{out['put_dispatch_carried_ms']!r} ms per carried; stall_staging {out['stall_staging_s']!r} s; "
        f"store peak {out['store_peak_bytes']} B")
    return out


def check_host_calls(label: str, report: dict, native_on: bool = True, group_by: bool = True) -> None:
    """The stage tasks ran every host pass of the run on the C++ kernels
    (take or take_multi, the narrowing and, unless the schedule has no
    map, the group-by scatter), and none on numpy; with ``native_on``
    False, the other way round."""
    ran, idle = report["native_calls"], report["plain_calls"]
    if not native_on:
        ran, idle = idle, ran
    need = {"take or take_multi": ran["take"] + ran["take_multi"], "narrow": ran["narrow"]}
    if group_by:
        need["group_rows"] = ran["group_rows"]
    short = [k for k, v in need.items() if v <= 0]
    if short or any(idle.values()):
        raise AssertionError(f"[{label}] host kernel calls: native {report['native_calls']}, numpy "
                             f"{report['plain_calls']} (none of {short}; want {'native' if native_on else 'numpy'})")


def batch_digest(torch, tensors):
    """Per staged tensor, on the card: the int64 sum of its 32-bit words
    and their sum weighted by position (1-based)."""
    out = []
    for t in tensors:
        x = t.contiguous().view(torch.int32).to(torch.int64)
        w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.int64)
        out += [x.sum(), (x * w).sum()]
    return torch.stack(out)


def profile_staging(ds, store):
    """Time each call of ``ds._stage`` and, on the stager's thread, of the
    store's ``get_columns`` (the consumer's mapping of a segment), by kind
    of batch: ``direct``; ``carried_mapped``, whose columns still view a
    segment's mapping; ``carried_owned``, rows the carry concatenated.
    Returns the ``(kind, thread, ms)`` records and a function that removes
    the wrappers."""
    import threading

    records = []
    stage, get_columns = ds._stage, store.get_columns

    def timed(kind, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        records.append((kind, threading.get_ident(), (time.perf_counter() - t0) * 1e3))
        return out

    def timed_stage(cb, direct=False):
        kind = "direct" if direct else ("carried_mapped" if cb._keepalive is not None else "carried_owned")
        return timed(kind, stage, cb, direct)

    ds._stage = timed_stage
    store.get_columns = lambda *a, **k: timed("get_columns", get_columns, *a, **k)

    def remove():
        del ds._stage, store.get_columns

    return records, remove


def staging_profile(records) -> dict:
    """Per kind of :func:`profile_staging` record: calls and the median ms
    of one call."""
    stager = {ident for kind, ident, _ in records if kind != "get_columns"}
    out = {}
    for kind in ("direct", "carried_mapped", "carried_owned", "get_columns"):
        ms = [t for k, ident, t in records if k == kind and ident in stager]
        if ms:
            out[kind] = {"n": len(ms), "median_ms": statistics.median(ms)}
    return out


@contextlib.contextmanager
def environment(env: dict, clear=()):
    """Set ``env`` (after removing the variables ``clear``) for the block,
    then put every variable back as it was."""
    keys = set(env) | set(clear)
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The training phases' heads (processes of this script with ``--<name>-head``)
# get their spec, environment included, through build/heads/<name>.json. The
# main run starts each one while the phase before it runs (start_head_early):
# its Python, torch, CUDA and the optimizer's imports, about 20 s a process
# on the card's host, then overlap that phase, and it waits for the file.
HEAD_DIR = os.path.join(ROOT, "build", "heads")
HEAD_WAIT_S = 900  # an early head's longest wait for its phase
_EARLY_HEADS: dict = {}


def _head_argv(name: str) -> list:
    spec_path = os.path.join(HEAD_DIR, f"{name}.json")
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"), f"--{name}-head", spec_path]


def start_head_early(name: str) -> None:
    """Start phase ``name``'s head now, to wait for the spec its phase writes."""
    os.makedirs(HEAD_DIR, exist_ok=True)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(os.path.join(HEAD_DIR, f"{name}.json"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    _EARLY_HEADS[name] = subprocess.Popen(_head_argv(name), env=env, cwd=ROOT)


def stop_early_heads() -> None:
    """Kill the early heads that no phase took."""
    for proc in _EARLY_HEADS.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    _EARLY_HEADS.clear()


def start_head(name: str, spec: dict, env: dict) -> subprocess.Popen:
    """Phase ``name``'s head running ``spec`` in the environment ``env``: the
    one started early, or a new process."""
    proc = _EARLY_HEADS.pop(name, None)
    if proc is None or proc.poll() is not None:
        os.makedirs(HEAD_DIR, exist_ok=True)
        proc = subprocess.Popen(_head_argv(name), env=env, cwd=ROOT)
    path = os.path.join(HEAD_DIR, f"{name}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({**spec, "env": env}, f)
    os.replace(path + ".tmp", path)
    return proc


def run_head(fn, spec_path: str) -> int:
    """A head's process: the optimizer's imports and CUDA first, then its spec
    (waited for until its phase writes it, or the process that started it
    is gone), whose environment replaces this process's before ``fn(spec)``
    imports the port."""
    import torch
    import torch._dynamo  # noqa: F401
    import torch._inductor  # noqa: F401

    torch.cuda.init()
    parent, deadline = os.getppid(), time.monotonic() + HEAD_WAIT_S
    while not os.path.exists(spec_path):
        if os.getppid() != parent or time.monotonic() > deadline:
            print(f"chip_smoke: no spec at {spec_path}", file=sys.stderr)
            return 3
        time.sleep(0.05)
    with open(spec_path) as f:
        spec = json.load(f)
    os.environ.clear()
    os.environ.update(spec.pop("env"))
    return fn(spec)


# (label, environment, cache_decoded): the delivery phase's runs. The first
# four deliver the defaults' stream: the index schedule forced, everything
# off, and the host kernels' plain numpy versions. The last two take the
# block plan with one row group a block, materialized and selective.
DELIVERY_RUNS = (
    ("defaults", {}, None),
    ("index_forced", {"RSDL_INDEX_SHUFFLE": "on"}, None),
    ("all_off", {"RSDL_DEVICE_DIRECT": "off", "RSDL_INDEX_SHUFFLE": "off"}, False),
    ("native_off", {"RSDL_DISABLE_NATIVE": "1"}, None),
    ("block_1", {"RSDL_SHUFFLE_PLAN": "block:1"}, None),
    ("block_1_selective", {"RSDL_SHUFFLE_PLAN": "block:1", "RSDL_SELECTIVE_READS": "auto"}, None),
)
ROWWISE_RUNS = ("defaults", "index_forced", "all_off", "native_off")
BLOCK_RUNS = ("block_1", "block_1_selective")


def phase_delivery(torch, filenames, num_rows: int, batch_size: int = 65536, device: str = "cuda") -> dict:
    """Delivery only (no step), 2 epochs on the slices' dataset
    (:data:`DELIVERY_RUNS`): each epoch delivers every key at most once and
    exactly the full batches' worth; every staged tensor of every batch is
    equal across the rowwise runs and across the block runs (per-batch
    digests computed on the card), which differ from each other; the forced
    run takes the index schedule in epoch 1; the host passes ran on the C++
    kernels, or all on numpy in ``native_off``; the selective run takes
    the selective schedule and decodes each row group of the dataset once
    an epoch."""
    import ray_shuffling_data_loader_tpu_torch as port

    feature_columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN] + [port.KEY_COLUMN]
    env_keys = sorted({k for _, env, _ in DELIVERY_RUNS for k in env})
    runs = {}
    port.runtime.init()
    try:
        for label, env, cache_decoded in DELIVERY_RUNS:
            with environment(env, clear=env_keys):
                t0 = time.perf_counter()
                ds = port.DeviceShufflingDataset(
                    filenames, num_epochs=2, num_trainers=1, batch_size=batch_size, rank=0,
                    feature_columns=feature_columns, label_column=port.LABEL_COLUMN, num_reducers=8, seed=0,
                    device=device, cache_decoded=cache_decoded,
                )
                records, unprofile = profile_staging(ds, port.runtime.get_context().store)
                digests = []
                try:
                    for epoch in range(2):
                        ds.set_epoch(epoch)
                        keys = []
                        for features, labels in ds:
                            keys.append(features[port.KEY_COLUMN])
                            digests.append(batch_digest(torch, [*features.values(), labels]))
                        got = torch.cat(keys)
                        want = (num_rows // batch_size) * batch_size
                        if got.numel() != want or torch.unique(got).numel() != want:
                            raise AssertionError(f"[delivery {label}] epoch {epoch}: {got.numel()} keys, "
                                                 f"{torch.unique(got).numel()} distinct; want {want}")
                finally:
                    unprofile()
                ds.join()
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report = delivery_report(port, ds, filenames, f"delivery {label}")
            report.update(wall_s=wall, batches=len(digests), staging_profile=staging_profile(records))
            runs[label] = (torch.stack(digests).cpu(), report)
            log(f"[delivery {label}] {len(digests)} batches in {wall!r} s, every key at most once per epoch")
            for kind, prof in report["staging_profile"].items():
                log(f"[delivery {label}] {kind}: {prof['n']} calls, median {prof['median_ms']!r} ms")
            check_host_calls(f"delivery {label}", report, native_on=label != "native_off",
                             group_by=label != "block_1_selective")
    finally:
        port.runtime.shutdown()
    for group in (ROWWISE_RUNS, BLOCK_RUNS):
        ref = runs[group[0]][0]
        for label in group:
            digest = runs[label][0]
            if digest.shape != ref.shape or not torch.equal(digest, ref):
                raise AssertionError(f"[delivery] {label}: staged tensors differ from the {group[0]} run's")
    if torch.equal(runs["defaults"][0], runs["block_1"][0]):
        raise AssertionError("[delivery] the block plan delivered the rowwise stream")
    if runs["index_forced"][1]["schedules"][1] != "index":
        raise AssertionError(f"[delivery] index_forced: schedules {runs['index_forced'][1]['schedules']}")
    off = runs["all_off"][1]
    if off["batches_direct"] or off["cache_decoded"] or set(off["schedules"]) != {"mapreduce"}:
        raise AssertionError(f"[delivery] all_off: {off}")
    sel = runs["block_1_selective"][1]
    groups = sorted((i, g) for i, f in enumerate(filenames) for g in range(len(port_row_groups(f))))
    if sel["schedules"] != ["selective", "selective"] or any(sel["selective_rowgroups"].get(e) != groups
                                                             for e in range(2)):
        raise AssertionError(f"[delivery] block_1_selective: schedules {sel['schedules']}, row groups decoded "
                             f"{sel['selective_rowgroups']}, want each of {len(groups)} once an epoch")
    for label in BLOCK_RUNS:
        log(f"[delivery {label}] shuffle {runs[label][1]['epoch_shuffle_s']!r} s per epoch "
            f"(schedules {runs[label][1]['schedules']})")
    log(f"[delivery] block_1_selective decoded each of the {len(groups)} row groups once in each epoch")
    log(f"[delivery] {runs['defaults'][0].shape[0]} batches, every staged tensor equal across {', '.join(ROWWISE_RUNS)}, "
        f"and across {', '.join(BLOCK_RUNS)}")
    return {label: report for label, (_, report) in runs.items()}


def port_row_groups(filename: str) -> list:
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

    return port_shuffle.file_row_group_sizes(filename)


def train_slice(torch, port, filenames, num_rows, model, label: str, collector=None, digests: bool = False) -> dict:
    """Two epochs of ``model`` on the shuffled dataset, with the launch
    counts set to 0 just before and read just after. ``collector``: a
    ``TrialStatsCollector`` actor that hears the run; its stats come back
    as ``trial``. ``digests``: also a digest of every staged tensor of
    each batch, ``key`` included, computed on the card."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch.ops as ops

    batch_size, num_epochs = 65536, 2
    feature_columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    step = port.make_train_step(model, port.make_optimizer(model))
    ds = port.DeviceShufflingDataset(
        filenames, num_epochs=num_epochs, num_trainers=1, batch_size=batch_size,
        rank=0,
        # "key" rides along for the exactly-once check and is dropped
        # before the step.
        feature_columns=[*feature_columns, port.KEY_COLUMN],
        label_column=port.LABEL_COLUMN, num_reducers=8, seed=0, device="cuda", stats_collector=collector,
    )
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    steps, step_s, losses, epoch_s = 0, [], [], []
    direct_per_epoch, staged = [], []
    last = None
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        keys = []
        direct0 = ds.stats.batches_direct
        t_epoch = time.perf_counter()
        for features, labels in ds:
            if digests:
                staged.append(batch_digest(torch, [*features.values(), labels]))
            keys.append(features.pop(port.KEY_COLUMN))
            t0 = time.perf_counter()
            loss = step(features, labels)["loss"].item()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            steps += 1
            last = (features, labels)
        epoch_s.append(time.perf_counter() - t_epoch)
        direct_per_epoch.append(ds.stats.batches_direct - direct0)
        got = torch.cat(keys).cpu().numpy()
        want_rows = (num_rows // batch_size) * batch_size
        if got.size != want_rows or np.unique(got).size != got.size:
            raise AssertionError(f"{label} epoch {epoch}: {got.size} keys, "
                                 f"{np.unique(got).size} distinct; want {want_rows}")
        if got.min() < 0 or got.max() >= num_rows:
            raise AssertionError(f"{label} epoch {epoch}: key out of range")
        log(f"[slice {label}] epoch {epoch}: {got.size} distinct keys exactly once, "
            f"{len(keys)} steps ({direct_per_epoch[-1]} staged direct), {epoch_s[-1]!r} s")
        if not direct_per_epoch[-1]:
            raise AssertionError(f"{label} epoch {epoch}: no batch was staged direct")
    launches = read_launches(ops)
    ds.join()  # the shuffle ended and the queue's name is free again
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    delivery = delivery_report(port, ds, filenames, f"slice {label}")
    check_host_calls(f"slice {label}", delivery)
    stats = ds.stats.as_dict()
    trial = None
    if collector is not None:
        collector.call_oneway("report_staging", 0, stats)
        trial = collector.call("get_stats", 60)
    median_ms = statistics.median(step_s[1:]) * 1e3
    log(f"[slice {label}] {steps} steps, losses {losses[0]!r} -> {losses[-1]!r}; "
        f"step median {median_ms!r} ms (first {step_s[0] * 1e3!r} ms); "
        f"stall {stats['stall_s']!r} s (upstream {stats['stall_upstream_s']!r}, "
        f"staging {stats['stall_staging_s']!r}) over {stats['stalls']} stalls; "
        f"first batch {stats['first_batch_s']!r} s; epochs {epoch_s!r} s; "
        f"launches {launches}; peak device memory {torch.cuda.max_memory_allocated()} B")
    return {
        "model": model,
        "batch": last,
        "launches": launches,
        "steps": steps,
        "step_ms_median": median_ms,
        "step_ms_first": step_s[0] * 1e3,
        "epoch_s": epoch_s,
        "losses": losses,
        "staging": stats,
        "delivery": delivery,
        "direct_per_epoch": direct_per_epoch,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "trial": trial,
        "audit_reconcile_s": ds.dataset.shuffle_stats.get("audit_reconcile_s"),
        "digests": torch.stack(staged).cpu().tolist() if staged else None,
    }


NUM_ROWS = 10**6


def phase_slices(torch, data_dir: str) -> dict:
    import ray_shuffling_data_loader_tpu_torch as port

    num_rows = NUM_ROWS
    port.runtime.init()
    try:
        t0 = time.perf_counter()
        filenames, nbytes = port.generate_data(num_rows, 10, 5, 0.0, data_dir, seed=0)
        log(f"[slice] generated {num_rows} rows ({nbytes} B) in {len(filenames)} files "
            f"in {time.perf_counter() - t0:.2f} s")
        collector = port.runtime.spawn_actor(port.TrialStatsCollector, 2, len(filenames), 8, num_rows, 65536, 1,
                                             name="slice-dlrm-stats")
        model = port.dlrm_for_data_spec()
        init_state = copy.deepcopy(model.state_dict())
        # The URI phase trains this run again from the same weights and holds
        # it bit for bit: CUDA's embedding backward is not deterministic.
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            dlrm = train_slice(torch, port, filenames, num_rows, model, "dlrm", collector, digests=True)
        finally:
            torch.use_deterministic_algorithms(False)
        dlrm["init_state"] = init_state
        n = dlrm["launches"]
        # bf16, (65536, 19, 32): the tensor-core route only.
        if (n["interaction"] != dlrm["steps"] or n["interaction_mma"] != dlrm["steps"]
                or any(v for k, v in n.items() if not k.startswith("interaction"))):
            raise AssertionError(f"dlrm: launches {n} in {dlrm['steps']} steps, want one K1 per "
                                 f"step, all on the tensor-core route")
        tab_model = port.transformer_for_data_spec()
        tab = train_slice(torch, port, filenames, num_rows, tab_model, "tabtransformer")
        n = tab["launches"]
        want = 2 * tab["steps"]  # two encoder layers
        # t = 19, hd = 8: the CUDA-core route only.
        if (n["interaction"] or any(n[k] for k in n if k.endswith("_mma"))
                or any(n[k] != want for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))):
            raise AssertionError(f"tabtransformer: launches {n}, want {want} of each flash kernel, "
                                 f"none on the tensor-core route")
        return {"dlrm": dlrm, "tabtransformer": tab, "filenames": filenames}
    finally:
        port.runtime.shutdown()


URI_CSVS = ("trial_stats.csv", "epoch_stats.csv", "consume_timeline.csv")


def _csv_shape(path: str) -> tuple:
    """``(header, data rows)`` of a CSV file."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], len(rows) - 1


def phase_uri(torch, filenames, reference: dict, data_dir: str, stats_dir: str) -> dict:
    """The DLRM main path with its Parquet and its stats behind ``file://``
    URIs (pyarrow's own filesystem: no fsspec, no local path). The slices'
    dataset written again to ``file://<data_dir>``: the same names under it,
    each file the same columns as the same-index local file (whether the
    bytes are equal too is logged). The DLRM slice over the URIs from
    ``reference``'s initial weights (``reference``: the slices phase's
    deterministic DLRM run), deterministic algorithms on: its staged
    tensors and 30 losses must equal the reference's bit for bit and K1
    launch once a step on its tensor-core route. ``dataset_num_rows`` over
    the URIs must be 10^6, and a resident staging of the URIs must pack the
    local files' buffer and deliver their epoch-0 keys. ``process_stats`` of
    the URI run's trial to ``file://<stats_dir>/uri`` must write the three
    CSVs with the headers and rows of a local write, and append with
    ``overwrite_stats=False``. Logs the maps' decode seconds per epoch
    through the resolver beside the reference's."""
    import filecmp

    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle
    from ray_shuffling_data_loader_tpu_torch.resident import DeviceResidentShufflingDataset, dataset_num_rows

    t_phase = time.perf_counter()
    smi = smi_name_and_limit()
    out = {}
    # A URI's directory is its store's to have: made here, not by the writers.
    os.makedirs(data_dir)
    os.makedirs(os.path.join(stats_dir, "uri"))
    port.runtime.init()
    try:
        # (1) Generation to a URI.
        t0 = time.perf_counter()
        uris, nbytes = port.generate_data(NUM_ROWS, 10, 5, 0.0, f"file://{data_dir}", seed=0)
        out["generate_s"] = time.perf_counter() - t0
        if uris != [f"file://{os.path.join(data_dir, os.path.basename(f))}" for f in filenames]:
            raise AssertionError(f"[uri] generated {uris}")
        t0 = time.perf_counter()
        for u, f in zip(uris, filenames):
            got, want = port_shuffle.read_parquet_columns(u), port_shuffle.read_parquet_columns(f)
            if list(got.columns) != list(want.columns) or not all(
                    np.array_equal(got.columns[k], want.columns[k]) for k in want.columns):
                raise AssertionError(f"[uri] {u} decodes to other columns than {f}")
        out["same_bytes"] = sum(filecmp.cmp(u[len("file://"):], f, shallow=False) for u, f in zip(uris, filenames))
        log(f"[uri] generated {NUM_ROWS} rows ({nbytes} B) in {len(uris)} files under file://{data_dir} in "
            f"{out['generate_s']!r} s; each decodes to the same-index local file's columns (both read in "
            f"{time.perf_counter() - t0!r} s); bytes equal to the local file's: {out['same_bytes']} of {len(uris)}")

        # (2) The DLRM slice over the URIs, from the reference's weights.
        collector = port.runtime.spawn_actor(port.TrialStatsCollector, 2, len(uris), 8, NUM_ROWS, 65536, 1,
                                             name="uri-dlrm-stats")
        model = port.dlrm_for_data_spec()
        model.load_state_dict(reference["init_state"])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run = train_slice(torch, port, uris, NUM_ROWS, model, "uri dlrm", collector, digests=True)
        finally:
            torch.use_deterministic_algorithms(False)
        n = run["launches"]
        if (run["steps"] != 30 or n["interaction"] != run["steps"] or n["interaction_mma"] != run["steps"]
                or any(v for k, v in n.items() if not k.startswith("interaction"))):
            raise AssertionError(f"[uri] launches {n} in {run['steps']} steps: want 30 K1, all tensor-core")
        if run["digests"] != reference["digests"] or run["losses"] != reference["losses"]:
            bad = [i for i, (a, b) in enumerate(zip(run["digests"], reference["digests"])) if a != b]
            raise AssertionError(f"[uri] the URI run differs from the local one: batches {bad[:5]}, losses "
                                 f"{run['losses'][:3]} against {reference['losses'][:3]}")
        decode = {label: [sum(e.map_read_durations) for e in r["trial"].epochs]
                  for label, r in (("uri", run), ("local", reference))}
        log(f"[uri] DLRM over file:// URIs: the local run's {len(run['digests'])} staged batches and "
            f"{len(run['losses'])} losses bit for bit; K1 {n['interaction_mma']} of {run['steps']} steps on the "
            f"tensor-core route")
        log(f"[uri] the maps' decode s per epoch (summed over the maps) through the resolver {decode['uri']!r} "
            f"against the slices phase's local paths {decode['local']!r}; shuffle s per epoch "
            f"{run['delivery']['epoch_shuffle_s']!r} against {reference['delivery']['epoch_shuffle_s']!r}; step "
            f"median {run['step_ms_median']!r} against {reference['step_ms_median']!r} ms ({smi})")

        # (3) The resident loader's footer reads and range decodes.
        if dataset_num_rows(uris) != NUM_ROWS:
            raise AssertionError(f"[uri] dataset_num_rows over the URIs: {dataset_num_rows(uris)}")
        features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
        staged = {}
        for label, files in (("uri", uris), ("local", filenames)):
            t0 = time.perf_counter()
            ds = DeviceResidentShufflingDataset(files, 1, 65536, [port.KEY_COLUMN, *features], port.LABEL_COLUMN,
                                                seed=0, device="cuda")
            try:
                stage_s = time.perf_counter() - t0
                ds.set_epoch(0)
                staged[label] = (ds._buf, torch.cat([f[port.KEY_COLUMN] for f, _ in ds]), stage_s)
            finally:
                ds.close()
        if not torch.equal(staged["uri"][0], staged["local"][0]) or not torch.equal(staged["uri"][1],
                                                                                    staged["local"][1]):
            raise AssertionError("[uri] the resident staging of the URIs differs from the local files'")
        log(f"[uri] resident: dataset_num_rows {NUM_ROWS}; the URIs' packed buffer {tuple(staged['uri'][0].shape)} "
            f"and epoch-0 keys ({staged['uri'][1].numel()}) equal the local files'; staged in "
            f"{staged['uri'][2]!r} s against {staged['local'][2]!r} s")

        # (4) Stats to a URI: the local write's CSVs, and an append.
        trial = run["trial"]
        for overwrite in (True, False):
            port.process_stats([trial], stats_dir=f"file://{stats_dir}/uri", overwrite_stats=overwrite)
            port.process_stats([trial], stats_dir=os.path.join(stats_dir, "local"), overwrite_stats=overwrite)
            shapes = {name: (_csv_shape(os.path.join(stats_dir, "uri", name)),
                             _csv_shape(os.path.join(stats_dir, "local", name))) for name in URI_CSVS}
            if any(a != b for a, b in shapes.values()):
                raise AssertionError(f"[uri] stats: the URI's CSVs {shapes}")
            out["stats_rows" if overwrite else "stats_rows_appended"] = {k: v[0][1] for k, v in shapes.items()}
        if any(out["stats_rows_appended"][k] != 2 * out["stats_rows"][k] for k in URI_CSVS) or not all(
                out["stats_rows"].values()):
            raise AssertionError(f"[uri] stats rows {out['stats_rows']}, appended {out['stats_rows_appended']}")
        if sys.modules.get("fsspec") is not None:
            raise AssertionError("[uri] fsspec was imported on a path that needs none")
        log(f"[uri] process_stats to file://{stats_dir}/uri: {', '.join(URI_CSVS)} with the local write's headers "
            f"and rows {out['stats_rows']}, appended {out['stats_rows_appended']}; fsspec never imported")
        out.update(launches=n, steps=run["steps"], step_ms_median=run["step_ms_median"], epoch_s=run["epoch_s"],
                   epoch_shuffle_s=run["delivery"]["epoch_shuffle_s"], decode_s=decode,
                   resident_stage_s={k: v[2] for k, v in staged.items()})
    finally:
        port.runtime.shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[uri] phase {out['wall_s']:.1f} s ({smi})")
    return out


AUDIT_KNOBS = ("RSDL_AUDIT", "RSDL_AUDIT_DIR", "RSDL_AUDIT_STRICT", "RSDL_AUDIT_KEY", "RSDL_JOURNAL", "RSDL_RESUME")


class _Drain:
    """A ``BatchConsumer`` that frees what it is given."""

    def __init__(self, port):
        self._store = port.runtime.get_context().store

    def consume(self, rank, epoch, batches):
        self._store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def stall_share(run: dict) -> float:
    return run["staging"]["stall_s"] / sum(run["epoch_s"])


def start_pool(port) -> float:
    """Start the session's worker pool and wait until every worker is up;
    returns its start-up seconds. A run that finds its pool started pays
    no start-up inside its first epoch, as the slices phase's first run
    does not (its pool starts with the decoded-size estimate, before the
    epochs)."""
    pool = port.runtime.get_context().pool
    while pool.ready_s is None:
        time.sleep(0.01)
    return pool.ready_s


def phase_audit(torch, filenames, num_rows: int, unaudited: dict, work: str) -> dict:
    """The audited main path on the slices' dataset (``RSDL_AUDIT=1``, the
    spool under ``work``, the session started after both are set): (a) the
    DLRM slice of :func:`train_slice`, whose every epoch must reconcile
    ``ok`` with map == reduce == delivered == consumed == every row, and K1
    once per step on its tensor-core route; (b) delivery only with
    ``drop_last=False``, staged == delivered, (c) under ``RSDL_JOURNAL``: a
    verdict per epoch journaled, and ``replay`` of the journal exits 0; (d)
    ``drop-row`` armed in epoch 0 of two: ``ok`` False with ``["delivered"]``
    in epoch 0 alone, and the same run under ``RSDL_AUDIT_STRICT=1`` raises
    ``AuditError``; (e) logs the audited run's shuffle seconds, step median
    and stall share beside ``unaudited`` (the slices phase's DLRM run), the
    digest seconds of each side, the spool's bytes and the seconds of the
    reconcile and the replay."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle
    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    spool, jdir = os.path.join(work, "spool"), os.path.join(work, "journal")
    feature_columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    out = {}

    def verdicts_ok(label, verdicts, epochs):
        for v in verdicts:
            rows = {k: v.get(k) for k in ("rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed")}
            if v["ok"] is not True or v["mismatch"] or any(r not in (num_rows, None) for r in rows.values()):
                raise AssertionError(f"[audit] {label}: epoch {v['epoch']} verdict {v}")
        if [v["epoch"] for v in verdicts] != list(range(epochs)):
            raise AssertionError(f"[audit] {label}: verdicts of epochs {[v['epoch'] for v in verdicts]}")

    t_phase = time.perf_counter()
    with environment({"RSDL_AUDIT": "1", "RSDL_AUDIT_DIR": spool}, clear=AUDIT_KNOBS):
        audit.refresh_from_env()
        audit.clear_faults()
        port.runtime.init()
        try:
            log(f"[audit] worker pool up in {start_pool(port)!r} s, audited")
            # (a) The audited main path.
            run = train_slice(torch, port, filenames, num_rows, port.dlrm_for_data_spec(), "audit dlrm")
            verdicts = audit.verdicts()
            verdicts_ok("dlrm", verdicts, 2)
            if any(v["rows_consumed"] != num_rows for v in verdicts):
                raise AssertionError(f"[audit] dlrm: the consumed side is missing: {verdicts}")
            n = run["launches"]
            if (n["interaction_mma"] != run["steps"] or n["interaction"] != run["steps"]
                    or any(v for k, v in n.items() if not k.startswith("interaction"))):
                raise AssertionError(f"[audit] dlrm: launches {n} in {run['steps']} steps, want one K1 per step, "
                                     "all on the tensor-core route")
            digest_s = audit.digest_seconds()
            spool_bytes = sum(os.path.getsize(os.path.join(spool, f)) for f in os.listdir(spool))
            for v in verdicts:
                log(f"[audit] dlrm epoch {v['epoch']}: ok, rows mapped {v['rows_mapped']} = reduced = delivered = "
                    f"consumed, staged {v['rows_staged']} (drop_last); digest {v['delivered_digest']}, seq "
                    f"{v['delivered_seq']}; adjacent pairs kept {v['adjacent_pair_retention']!r}, displacement "
                    f"{v['mean_normalized_displacement']!r}, source entropy {v['source_entropy_mean']!r} "
                    f"(min {v['source_entropy_min']!r}); plan {v['plan']}")
            # The worker sides' digests, timed here on the same numbers of
            # keys cut as they cut them: 10 files, 8 reducers.
            keys = np.random.default_rng(0).permutation(num_rows).astype(np.int32)
            worker_s = {}
            for side, parts in (("map", len(filenames)), ("reduce", 8)):
                t0 = time.perf_counter()
                for part in np.array_split(keys, parts):
                    audit.StreamDigest().update(part)
                worker_s[side] = time.perf_counter() - t0
            out["dlrm"] = {
                "verdicts": verdicts, "launches": n, "steps": run["steps"], "step_ms_median": run["step_ms_median"],
                "epoch_s": run["epoch_s"], "epoch_shuffle_s": run["delivery"]["epoch_shuffle_s"],
                "stall_share": stall_share(run), "staging": run["staging"],
                "digest_s_driver": digest_s, "digest_s_epoch_keys_timed_here": worker_s,
                "spool_bytes": spool_bytes, "reconcile_s": run["audit_reconcile_s"],
            }
            log(f"[audit] (e) audited against unaudited DLRM slice: shuffle s per epoch "
                f"{out['dlrm']['epoch_shuffle_s']!r} against {unaudited['delivery']['epoch_shuffle_s']!r}; step "
                f"median {run['step_ms_median']!r} against {unaudited['step_ms_median']!r} ms; stall share "
                f"{stall_share(run)!r} against {stall_share(unaudited)!r}; epochs {run['epoch_s']!r} against "
                f"{unaudited['epoch_s']!r} s")
            log(f"[audit] (e) digest s over the run in the trainer's process, per side: {digest_s}; the workers' "
                f"sides of one epoch timed here on {num_rows} int32 keys: {worker_s}; spool {spool_bytes} B; reconcile "
                f"{run['audit_reconcile_s']!r} s")

            # (b) + (c) Delivery only, drop_last off, journaled; then replay.
            with environment({"RSDL_JOURNAL": jdir}):
                ds = port.DeviceShufflingDataset(
                    filenames, num_epochs=2, num_trainers=1, batch_size=65536, rank=0,
                    feature_columns=[*feature_columns, port.KEY_COLUMN], label_column=port.LABEL_COLUMN,
                    num_reducers=8, seed=0, device="cuda", drop_last=False,
                )
                for epoch in range(2):
                    ds.set_epoch(epoch)
                    rows = sum(int(labels.shape[0]) for _, labels in ds)
                    if rows != num_rows:
                        raise AssertionError(f"[audit] delivery epoch {epoch}: {rows} rows staged")
                ds.join()
            verdicts = audit.verdicts()
            verdicts_ok("delivery", verdicts, 2)
            if any(v["rows_staged"] != v["rows_delivered"] for v in verdicts):
                raise AssertionError(f"[audit] delivery: staged != delivered: {verdicts}")
            journal = ds.dataset.shuffle_stats["journal"]
            state = jmod.load_run(journal)
            if sorted(state.verdicts) != [0, 1] or any(
                    state.verdicts[e]["delivered_seq"] != verdicts[e]["delivered_seq"] for e in (0, 1)):
                raise AssertionError(f"[audit] journal {journal}: verdicts {state.verdicts}")
            log(f"[audit] (b) delivery, drop_last off: staged {[v['rows_staged'] for v in verdicts]} = delivered "
                f"in both epochs; (c) journal holds a verdict per epoch")
            env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
            report = os.path.join(work, "replay.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.replay", journal, "--workers", "8",
                 "--json", report], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
            )
            replay_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"[audit] replay exited {proc.returncode}: {proc.stdout[-2000:]} "
                                     f"{proc.stderr[-2000:]}")
            with open(report) as f:
                replayed = json.load(f)
            if sorted(replayed["epochs"]) != ["0", "1"] or not all(e["ok"] for e in replayed["epochs"].values()):
                raise AssertionError(f"[audit] replay report: {replayed}")
            log(f"[audit] (c) replay reproduced epochs {sorted(replayed['epochs'])} (exit 0) in {replay_s!r} s")
            out["delivery"] = {"verdicts": verdicts, "replay_s": replay_s,
                               "reconcile_s": ds.dataset.shuffle_stats["audit_reconcile_s"]}

            # (d) The injected fault, then strict mode.
            audit.inject_fault("drop-row", 0)
            port_shuffle.shuffle(filenames, _Drain(port), 2, 8, 1, seed=0, narrow_to_32=True)
            verdicts = audit.verdicts()
            if ([v["ok"] for v in verdicts] != [False, True] or verdicts[0]["mismatch"] != ["delivered"]
                    or verdicts[0]["rows_delivered"] != num_rows - 1):
                raise AssertionError(f"[audit] drop-row in epoch 0: verdicts {verdicts}")
            audit.inject_fault("drop-row", 0)
            raised = None
            with environment({"RSDL_AUDIT_STRICT": "1"}):
                try:
                    port_shuffle.shuffle(filenames, _Drain(port), 1, 8, 1, seed=0, narrow_to_32=True)
                except audit.AuditError as exc:
                    raised = exc
            if raised is None:
                raise AssertionError("[audit] strict mode did not raise AuditError on a dropped row")
            log(f"[audit] (d) drop-row armed in epoch 0: ok {[v['ok'] for v in verdicts]}, mismatch "
                f"{verdicts[0]['mismatch']} ({verdicts[0]['rows_delivered']} rows delivered); strict raised "
                f"AuditError({raised})")
            out["fault"] = {"verdicts": verdicts, "strict_raised": str(raised)}
        finally:
            audit.clear_faults()
            port.runtime.shutdown()
    audit.refresh_from_env()
    audit.reset()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[audit] phase {out['wall_s']:.1f} s")
    return out


# (name, environment of both hosts): the cluster phase's two clusters, one
# after the other. The transport's gates are read once per process, so each
# setting needs hosts of its own.
CLUSTER_CONFIGS = (("pickle", {}), ("zerocopy4", {"RSDL_TCP_ZEROCOPY": "1", "RSDL_TCP_STREAMS": "4"}))
CLUSTER_WORKERS = 4  # each host's pool: the two hosts share the machine's cores
FETCH_BENCH_BYTES = 256 << 20  # the loopback fetch's segment, about two reducer outputs of the slice


def cluster_run(torch, port, filenames, label: str, model=None, init_state=None, tag: str = "cluster",
                epochs: int = 2, cache_decoded=None, seed: int = 0, queue_name: str = "BatchQueue") -> dict:
    """``epochs`` epochs of the slices' dataset through ``DeviceShufflingDataset``
    (batch 65536, 8 reducers, ``seed``): with ``model``, the DLRM trained from
    ``init_state`` (a fresh Adam 1e-3), else delivery alone. Per batch a
    digest of every staged tensor, ``key`` included, on the card; each
    epoch's keys exactly once; the losses, the step and epoch seconds, the
    stall, the shuffle's statistics and the audit's verdicts; its
    recoveries (``stage_retries``, ``rematerialized``, ``recovery_log``),
    journal and plan compiler's terms and re-plans; the queue actor's name.
    K1's launches are the caller's to count. ``tag`` heads its log lines;
    ``cache_decoded`` goes to the dataset (None: the shuffle's policy), and
    so does ``queue_name``."""
    import numpy as np

    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    batch_size = 65536
    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    step = None
    if model is not None:
        model.load_state_dict(init_state)
        step = port.make_train_step(model, port.make_optimizer(model))
    ds = port.DeviceShufflingDataset(
        filenames, num_epochs=epochs, num_trainers=1, batch_size=batch_size, rank=0,
        feature_columns=[*features, port.KEY_COLUMN], label_column=port.LABEL_COLUMN, num_reducers=8, seed=seed,
        device="cuda", cache_decoded=cache_decoded, queue_name=queue_name,
    )
    queue = ds.dataset._batch_queue.actor.name  # the handle goes at the join
    digests, losses, step_s, epoch_s = [], [], [], []
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        keys = []
        t_epoch = time.perf_counter()
        for feats, labels in ds:
            digests.append(batch_digest(torch, [*feats.values(), labels]))
            keys.append(feats.pop(port.KEY_COLUMN))
            if step is not None:
                t0 = time.perf_counter()
                losses.append(step(feats, labels)["loss"].item())
                step_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t_epoch)
        got = torch.cat(keys).cpu().numpy()
        want = (NUM_ROWS // batch_size) * batch_size
        if got.size != want or np.unique(got).size != want or got.min() < 0 or got.max() >= NUM_ROWS:
            raise AssertionError(f"[{tag} {label}] epoch {epoch}: {got.size} keys, {np.unique(got).size} distinct; "
                                 f"want {want} in [0, {NUM_ROWS})")
    ds.join()
    stats, staging = ds.dataset.shuffle_stats, ds.stats.as_dict()
    if losses and not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{tag} {label}] non-finite loss: {losses}")
    run = {
        "digests": torch.stack(digests).cpu().tolist(), "losses": losses, "steps": len(losses),
        "step_ms_median": statistics.median(step_s[1:]) * 1e3 if step_s else None, "epoch_s": epoch_s,
        "epoch_shuffle_s": stats.get("epoch_shuffle_s"), "stall_s": staging["stall_s"],
        "stall_share": staging["stall_s"] / sum(epoch_s), "native_calls": stats.get("native_calls"),
        "plain_calls": stats.get("plain_calls"), "schedules": [s for _, s in ds.dataset.schedule_log],
        "verdicts": audit.verdicts(), "journal": stats.get("journal"),
        "recovery": {k: stats.get(k) for k in ("stage_retries", "rematerialized", "recovery_log")},
        "plan_terms": stats.get("plan_terms"), "plan_replans": stats.get("plan_replans"),
        "store_peak_bytes": stats.get("store_peak_bytes"), "cache_decoded": stats.get("cache_decoded"),
        "decode_rowgroups": stats.get("decode_rowgroups"), "shared_cache_hits": stats.get("shared_cache_hits"),
        "queue": queue,
    }
    log(f"[{tag} {label}] {len(digests)} batches, {run['steps']} steps; schedules {run['schedules']}; shuffle s per "
        f"epoch {run['epoch_shuffle_s']!r}; epochs {epoch_s!r} s; step median {run['step_ms_median']!r} ms; stall "
        f"{run['stall_s']!r} s (share {run['stall_share']!r}); host kernel calls {run['native_calls']}")
    return run


def cluster_fetch_bench(ctx, joined_shm: str) -> dict:
    """The loopback fetch's GB/s (best of 3) of a ``FETCH_BENCH_BYTES``
    segment of the joined host, into a buffer of the head's touched
    beforehand: the pickled ``fetch``, the zero-copy ``fetch_vec`` on one
    stream, and striped over 4."""
    import concurrent.futures
    import mmap

    import numpy as np

    from ray_shuffling_data_loader_tpu_torch.runtime import cluster as port_cluster
    from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle

    hosts = ctx.cluster.registry.call("hosts")
    other = next(h for h in hosts if h != ctx.cluster.host_id)
    # A segment of the joined host's session, written in its directory
    # (one machine): its session's end reclaims it.
    writer = port_store.ObjectStore(other.split(":", 1)[1], shm_dir=joined_shm)
    writer.owner_address = tuple(hosts[other]["store"])
    ref = writer.put_columns({"x": np.arange(FETCH_BENCH_BYTES // 4, dtype=np.int32)})
    handle = ActorHandle(tuple(hosts[other]["store"]))
    want = handle.call("fetch", ref.object_id, None)
    dest = mmap.mmap(-1, len(want))
    dest.write(bytes(len(want)))  # touched: the fetch writes into present pages
    out = {"bytes": len(want)}
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            for name in ("pickle", "streams_1", "streams_4"):
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    if name == "pickle":
                        got = handle.call("fetch", ref.object_id, None)
                    elif name == "streams_1":
                        _, view = handle.call_vectored("fetch_vec", ref.object_id, None, into=lambda n: dest)
                        view.release()
                    else:
                        port_cluster.fetch_vec_striped(handle, ref.object_id, None, lambda n: dest, 4, pool)
                    best = min(best, time.perf_counter() - t0)
                    if name != "pickle":
                        got = dest[: len(want)]
                    if got != want:
                        raise AssertionError(f"[cluster] fetch bench {name}: bytes differ")
                    del got
                out[name] = {"s": best, "GB_s": len(want) / best / 1e9}
    finally:
        dest.close()
        writer.free(ref)
    log(f"[cluster] loopback fetch of {len(want)} B, best of 3: pickled {out['pickle']['GB_s']!r} GB/s, "
        f"zero-copy 1 stream {out['streams_1']['GB_s']!r} GB/s, 4 streams {out['streams_4']['GB_s']!r} GB/s")
    return out


def cluster_hosts_state(ctx) -> dict:
    """Per host: its agent's completed tasks and its store server's bytes
    served to the other."""
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle

    return {host: {"tasks": ActorHandle(tuple(info["agent"])).call("agent_stats")["completed"],
                   "served_bytes": ActorHandle(tuple(info["store"])).call("fetch_stats")["bytes"]}
            for host, info in ctx.cluster.registry.call("hosts").items()}


def cluster_head(spec: dict) -> int:
    """The ``[cluster]`` phase's head, a process of its own (a process holds
    one session at a time): the deterministic DLRM slice on this host alone,
    then for each of :data:`CLUSTER_CONFIGS` a cluster (``init_cluster``,
    its address written for the joined host that the phase starts): the
    DLRM slice on it from the same weights, delivery alone with
    ``RSDL_REDUCE_FETCH_OVERLAP=off`` and the loopback fetch's rates (first
    cluster), or delivery alone (second). Writes the runs to
    ``spec["result"]``; the phase checks them."""
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.runtime import transport
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle

    # CUDA's embedding backward is not deterministic: the runs' losses are
    # held bit-equal under deterministic algorithms, as in the plan phase.
    torch.use_deterministic_algorithms(True, warn_only=True)
    files = spec["files"]
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    out = {}
    with environment({"RSDL_AUDIT_DIR": spec["spool_single"]}):
        port.runtime.init()
        try:
            log(f"[cluster] one host: worker pool up in {start_pool(port)!r} s")
            out["single"] = cluster_run(torch, port, files, "single", model, init_state)
        finally:
            port.runtime.shutdown()
    for name, env in CLUSTER_CONFIGS:
        with environment({**env, "RSDL_AUDIT_DIR": spec["spool"]}):
            transport.refresh_zerocopy_from_env()
            transport.refresh_tcp_streams_from_env()
            t0 = time.perf_counter()
            ctx = port.runtime.init_cluster(advertise_host="127.0.0.1", num_workers=CLUSTER_WORKERS)
            try:
                addr = spec["addr"][name]
                with open(addr + ".tmp", "w") as f:
                    f.write(ctx.cluster.address)
                os.replace(addr + ".tmp", addr)
                deadline = time.monotonic() + 60
                while len(port.runtime.cluster_hosts()) < 2:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"[cluster {name}] the second host did not join")
                    time.sleep(0.05)
                # Each agent's pool up before the epochs, as the one host's.
                for info in ctx.cluster.registry.call("hosts").values():
                    ActorHandle(tuple(info["agent"])).call("submit", os.getpid, (), {})
                up_s = time.perf_counter() - t0
                before = cluster_hosts_state(ctx)
                if name == "pickle":
                    reset_launches(ops)
                    run = cluster_run(torch, port, files, "cluster", model, init_state)
                    run["launches"] = read_launches(ops)
                    after = cluster_hosts_state(ctx)
                    with environment({"RSDL_REDUCE_FETCH_OVERLAP": "off"}):
                        out["overlap_off"] = cluster_run(torch, port, files, "overlap_off")
                    run["fetch_bench"] = cluster_fetch_bench(ctx, spec["joined_shm"][name])
                else:
                    run = cluster_run(torch, port, files, name)
                    after = cluster_hosts_state(ctx)
                run["hosts"] = {h: {k: after[h][k] - before[h][k] for k in after[h]} for h in after}
                run["up_s"] = up_s
                log(f"[cluster {name}] cluster of 2 hosts up in {up_s!r} s; per host during the run: {run['hosts']}")
                out["cluster" if name == "pickle" else name] = run
            finally:
                port.runtime.shutdown()
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def phase_cluster(torch, filenames, unaudited: dict, work: str) -> dict:
    """The cluster plane on the slices' dataset: a head process
    (:func:`cluster_head`) and, per cluster, a host joined with ``python -m
    ...runtime.cluster join`` on the same machine, each host with its own
    shared-memory and spill directories and both with one audit spool. The
    cluster's DLRM run must stage the one host's tensors and train its
    losses bit for bit, every epoch reconcile ``ok`` with every row mapped,
    reduced, delivered and consumed, both agents run tasks, bytes cross
    hosts, the reduces take the overlapped path, and K1 launch once a step
    on its tensor-core route; delivery with the overlap off and over the
    zero-copy plane striped on 4 streams must stage the same tensors; and
    no segment may be left in any host's directories."""
    t_phase = time.perf_counter()
    tag = f"rsdl-cluster-{os.getpid()}"
    dirs = {"head": {"RSDL_SHM_DIR": f"/dev/shm/{tag}-head", "RSDL_SPILL_DIR": os.path.join(work, "spill-head")}}
    for name, _ in CLUSTER_CONFIGS:
        dirs[name] = {"RSDL_SHM_DIR": f"/dev/shm/{tag}-{name}", "RSDL_SPILL_DIR": os.path.join(work, f"spill-{name}")}
    spec = {
        "files": filenames, "result": os.path.join(work, "result.json"),
        "spool": os.path.join(work, "spool"), "spool_single": os.path.join(work, "spool-single"),
        "addr": {name: os.path.join(work, f"address-{name}") for name, _ in CLUSTER_CONFIGS},
        "joined_shm": {name: dirs[name]["RSDL_SHM_DIR"] for name, _ in CLUSTER_CONFIGS},
    }
    base = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    base.update(RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_AUDIT="1")
    procs = {}
    try:
        procs["head"] = start_head("cluster", spec, {**base, **dirs["head"]})
        for name, env in CLUSTER_CONFIGS:
            deadline = time.monotonic() + 240
            while not os.path.exists(spec["addr"][name]):
                if procs["head"].poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"[cluster] the head exited ({procs['head'].poll()}) or timed out before "
                                         f"the {name} cluster's address")
                time.sleep(0.05)
            with open(spec["addr"][name]) as f:
                address = f.read()
            with open(os.path.join(work, f"joined-{name}.log"), "w") as out_f:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.runtime.cluster", "join", address,
                     "--num-workers", str(CLUSTER_WORKERS)],
                    env={**base, **env, **dirs[name], "RSDL_AUDIT_DIR": spec["spool"]}, cwd=ROOT, stdout=out_f,
                    stderr=subprocess.STDOUT)
        for name, proc in procs.items():
            # A joined host leaves once its head's registry is gone.
            code = proc.wait(timeout=300 if name == "head" else 60)
            if code != 0:
                logs = {n: open(os.path.join(work, f"joined-{n}.log")).read()[-3000:] for n in procs if n != "head"}
                raise AssertionError(f"[cluster] {name} exited {code}; joined hosts' logs: {logs}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(spec["result"]) as f:
        res = json.load(f)
    left = {d: os.listdir(d) for host in dirs.values() for d in host.values() if os.path.isdir(d) and os.listdir(d)}
    for host in dirs.values():
        shutil.rmtree(host["RSDL_SHM_DIR"], ignore_errors=True)
    if left:
        raise AssertionError(f"[cluster] segments left after shutdown: {left}")
    single, run = res["single"], res["cluster"]
    for label in ("single", "cluster"):
        for v in res[label]["verdicts"]:
            rows = [v[k] for k in ("rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed")]
            if v["ok"] is not True or v["mismatch"] or rows != [NUM_ROWS] * 4:
                raise AssertionError(f"[cluster] {label}: epoch {v['epoch']} verdict {v}")
        if [v["epoch"] for v in res[label]["verdicts"]] != [0, 1]:
            raise AssertionError(f"[cluster] {label}: verdicts {res[label]['verdicts']}")
    for got, want in zip(run["verdicts"], single["verdicts"]):
        for key, value in want.items():
            same = (abs(got[key] - value) <= 1e-12 if key.startswith("source_entropy") else got[key] == value)
            if not same:
                raise AssertionError(f"[cluster] verdict {key} of epoch {want['epoch']}: {got[key]!r} on the cluster, "
                                     f"{value!r} on one host")
    if run["digests"] != single["digests"]:
        raise AssertionError("[cluster] the cluster staged other tensors than the one host")
    if run["losses"] != single["losses"]:
        diff = max(abs(a - b) for a, b in zip(run["losses"], single["losses"]))
        raise AssertionError(f"[cluster] losses differ from the one host's by up to {diff!r}")
    for label in ("overlap_off", "zerocopy4"):
        if res[label]["digests"] != run["digests"]:
            raise AssertionError(f"[cluster] {label}: other staged tensors than the cluster's DLRM run")
    n = run["launches"]
    if (n["interaction"] != run["steps"] or n["interaction_mma"] != run["steps"]
            or any(v for k, v in n.items() if not k.startswith("interaction"))):
        raise AssertionError(f"[cluster] launches {n} in {run['steps']} steps, want one K1 per step, all on the "
                             "tensor-core route")
    for label in ("cluster", "zerocopy4"):
        hosts = res[label]["hosts"]
        if len(hosts) != 2 or not all(h["tasks"] > 0 for h in hosts.values()):
            raise AssertionError(f"[cluster] {label}: tasks per host {hosts}")
        if not sum(h["served_bytes"] for h in hosts.values()):
            raise AssertionError(f"[cluster] {label}: no byte crossed hosts: {hosts}")
        if not res[label]["native_calls"]["scatter"]:
            raise AssertionError(f"[cluster] {label}: no reduce took the overlapped path: {res[label]['native_calls']}")
    if res["overlap_off"]["native_calls"]["scatter"]:
        raise AssertionError(f"[cluster] overlap off still scattered: {res['overlap_off']['native_calls']}")
    log(f"[cluster] the cluster staged the one host's {len(run['digests'])} batches and trained its "
        f"{len(run['losses'])} losses bit for bit ({run['losses'][0]!r} -> {run['losses'][-1]!r}); both epochs ok, "
        f"{NUM_ROWS} rows mapped = reduced = delivered = consumed; overlap off and zero-copy on 4 streams staged "
        f"the same; no segment left")
    log(f"[cluster] shuffle s per epoch: one host (deterministic) {single['epoch_shuffle_s']!r}, cluster "
        f"{run['epoch_shuffle_s']!r}, overlap off {res['overlap_off']['epoch_shuffle_s']!r}, zero-copy 4 streams "
        f"{res['zerocopy4']['epoch_shuffle_s']!r}; the slices phase's DLRM {unaudited['delivery']['epoch_shuffle_s']!r}")
    log(f"[cluster] step median {run['step_ms_median']!r} ms (one host {single['step_ms_median']!r}, the slices "
        f"phase's {unaudited['step_ms_median']!r}); stall share {run['stall_share']!r} (one host "
        f"{single['stall_share']!r}, the slices phase's {stall_share(unaudited)!r}); bytes served per host "
        f"{ {h: v['served_bytes'] for h, v in run['hosts'].items()} }")
    for label, r in res.items():
        if label != "single":  # the fault phase's reference
            r.pop("digests", None)
    res["wall_s"] = time.perf_counter() - t_phase
    res["launches"] = n
    log(f"[cluster] phase {res['wall_s']:.1f} s")
    return res


# The fault phase's recovered run: one seeded schedule over 2 pool workers
# (each rule fires at most once a process, so a task's retries meet at most
# as many unspent rules as there are workers), a crashed map entry and a
# crashed reduce exit in each epoch, a worker killed in a reduce, a lost
# store object on a worker and a reset of a driver's send to the queue
# actor. The seed puts the kill at a worker's twelfth invocation of the
# reduce site and the lost object at its seventeenth read: a worker started
# in place of a dead one does work before any rule can fire on it again.
# A task's retries can still meet a fresh worker's rules one after another
# (the driver retries one task at a time): a task took up to 5 attempts in
# CPU rehearsals of this schedule at 20,000 rows, hence a budget of 8.
FAULTS_SPEC = ("task.map/task:crash-entry:1@0x1,task.map/task:crash-entry:1@1x1,"
               "task.reduce/task:crash-exit:1@0x1,task.reduce/task:crash-exit:1@1x1,"
               "task.reduce/task:kill:0.3x1,store.get/task:lost:0.1x1,transport.send/driver:reset:0.05x1")
FAULTS_SEED = 60
FAULTS_WORKERS = 2
FAULTS_ATTEMPTS = 8
POISON_SPEC = "task.map:crash-entry:1.0"
POISON_BOUND_S = 60.0
FAULTS_KNOBS = ("RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_FAULTS_DELAY_S", "RSDL_STAGE_MAX_ATTEMPTS", "RSDL_JOURNAL",
                "RSDL_INDEX_SHUFFLE", "RSDL_AUDIT_STRICT")
# The failover run's joined host: every epoch-0 reduce there waits this long
# at its entry, so that the host dies after epoch 0's maps and before any of
# its reduces publishes.
FAILOVER_DELAY_S = "8"


def _left(dirs) -> dict:
    return {d: sorted(os.listdir(d)) for d in dirs if os.path.isdir(d) and os.listdir(d)}


def _journal_maps(directory: str, epoch: int) -> int:
    """The ``map`` records of ``epoch`` in the run journal under
    ``directory`` (0 before it exists)."""
    import glob

    n = 0
    for path in glob.glob(os.path.join(directory, "run-*.ndjson")):
        with open(path) as f:
            for line in f:
                if '"kind": "map"' in line and json.loads(line).get("epoch") == epoch:
                    n += 1
    return n


def faults_head(spec: dict) -> int:
    """The ``[faults]`` phase's runs, in a process of their own (its shm and
    spill directories are the phase's): (1) the recovered run, journaled;
    (2) ``replay`` of its journal; (3) the poison; (4) failover: a cluster
    whose joined host is SIGKILLed after epoch 0's maps. Every training run
    starts from the DLRM's seeded weights under deterministic algorithms,
    as the ``[cluster]`` phase's one-host run, the reference. Writes the
    results to ``spec["result"]``; the phase checks them."""
    import signal
    import threading

    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle
    from ray_shuffling_data_loader_tpu_torch.shuffle import StageFailedError
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    torch.use_deterministic_algorithms(True, warn_only=True)
    files, dirs = spec["files"], [os.environ["RSDL_SHM_DIR"], os.environ["RSDL_SPILL_DIR"]]
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    out = {}

    def armed(schedule: str, seed: int, **extra):
        env = {"RSDL_AUDIT_DIR": spec["spool"], "RSDL_AUDIT_STRICT": "1", **extra}
        if schedule:
            env.update(RSDL_FAULTS=schedule, RSDL_FAULTS_SEED=str(seed))
        return environment(env, clear=FAULTS_KNOBS)

    # (1) The recovered run: the schedule armed before the session starts.
    with armed(FAULTS_SPEC, FAULTS_SEED, RSDL_STAGE_MAX_ATTEMPTS=str(FAULTS_ATTEMPTS), RSDL_INDEX_SHUFFLE="off",
               RSDL_JOURNAL=spec["journal"]):
        audit.refresh_from_env()
        faults.refresh_from_env()
        ctx = port.runtime.init(num_workers=FAULTS_WORKERS)
        try:
            log(f"[faults] recovered: worker pool up in {start_pool(port)!r} s; schedule {FAULTS_SPEC} seed "
                f"{FAULTS_SEED}, {FAULTS_ATTEMPTS} attempts")
            reset_launches(ops)
            run = cluster_run(torch, port, files, "recovered", model, init_state, tag="faults")
            run["launches"] = read_launches(ops)
            run["driver_fired"] = {f"{s}:{k}": n for (s, k), n in faults.fired_counts().items()}
            run["pool_deaths"] = ctx.pool.deaths
        finally:
            port.runtime.shutdown()
    faults.refresh_from_env()
    run["left"] = _left(dirs)
    out["recovered"] = run

    # (2) Replay of the recovered run's journal, with the schedule re-armed.
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env.update({k: os.environ[k] for k in ("RSDL_SHM_DIR", "RSDL_SPILL_DIR")})
    # The journal records the schedule, not the budget it was recovered in.
    env["RSDL_STAGE_MAX_ATTEMPTS"] = str(FAULTS_ATTEMPTS)
    report = os.path.join(spec["work"], "replay.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.replay", run["journal"], "--workers",
         str(FAULTS_WORKERS), "--json", report], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    out["replay"] = {"code": proc.returncode, "s": time.perf_counter() - t0, "stderr": proc.stderr[-3000:]}
    if proc.returncode == 0:
        with open(report) as f:
            out["replay"]["report"] = json.load(f)
    log(f"[faults] replay exited {proc.returncode} in {out['replay']['s']!r} s")

    # (3) The poison: every map attempt crashes.
    with armed(POISON_SPEC, 3, RSDL_STAGE_MAX_ATTEMPTS="3"):
        audit.refresh_from_env()
        faults.refresh_from_env()
        port.runtime.init(num_workers=FAULTS_WORKERS)
        poison = {}
        try:
            start_pool(port)
            features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
            ds = port.DeviceShufflingDataset(files, num_epochs=2, num_trainers=1, batch_size=65536, rank=0,
                                             feature_columns=features, label_column=port.LABEL_COLUMN,
                                             num_reducers=8, seed=0, device="cuda")
            ds.set_epoch(0)
            t0 = time.perf_counter()
            try:
                poison["batches"] = sum(1 for _ in ds)
            except StageFailedError as exc:
                poison.update(raised=type(exc).__name__, stage=exc.stage, epoch=exc.epoch, attempts=exc.attempts)
            poison["s"] = time.perf_counter() - t0
            poison["released"] = ds._copy_stream is None and all(b is None for b in ds._pinned)
        finally:
            port.runtime.shutdown()
    faults.refresh_from_env()
    poison["left"] = _left(dirs)
    out["poison"] = poison
    log(f"[faults] poison: {poison}")

    # (4) Failover: a head and a joined host; the joined host (its agent,
    # store server and workers) SIGKILLed once epoch 0's maps are journaled.
    joined_dirs = [spec["joined_shm"], spec["joined_spill"]]
    with armed("", 0, RSDL_JOURNAL=spec["journal_failover"]):
        audit.refresh_from_env()
        faults.refresh_from_env()
        ctx = port.runtime.init_cluster(advertise_host="127.0.0.1", num_workers=CLUSTER_WORKERS)
        joined = None
        try:
            joined_env = {k: v for k, v in os.environ.items() if k not in FAULTS_KNOBS}
            joined_env.update(RSDL_SHM_DIR=joined_dirs[0], RSDL_SPILL_DIR=joined_dirs[1],
                              RSDL_FAULTS="task.reduce/task:delay:1@0", RSDL_FAULTS_DELAY_S=FAILOVER_DELAY_S)
            with open(os.path.join(spec["work"], "joined.log"), "w") as logf:
                joined = subprocess.Popen(
                    [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.runtime.cluster", "join",
                     ctx.cluster.address, "--num-workers", str(CLUSTER_WORKERS)],
                    env=joined_env, cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
            deadline = time.monotonic() + 60
            while len(port.runtime.cluster_hosts()) < 2:
                if time.monotonic() > deadline or joined.poll() is not None:
                    raise RuntimeError("[faults] the second host did not join")
                time.sleep(0.05)
            for info in ctx.cluster.registry.call("hosts").values():
                ActorHandle(tuple(info["agent"])).call("submit", os.getpid, (), {})
            killed = {}

            def kill_after_maps():
                while _journal_maps(spec["journal_failover"], 0) < len(files):
                    if joined.poll() is not None:
                        return
                    time.sleep(0.01)
                os.killpg(joined.pid, signal.SIGKILL)
                killed["at"] = time.perf_counter()

            killer = threading.Thread(target=kill_after_maps, daemon=True)
            killer.start()
            t0 = time.perf_counter()
            reset_launches(ops)
            run = cluster_run(torch, port, files, "failover", model, init_state, tag="faults")
            run["launches"] = read_launches(ops)
            killer.join(timeout=5)
            run["killed_after_s"] = killed["at"] - t0 if "at" in killed else None
            run["hosts_after"] = port.runtime.cluster_hosts()
            run["agents_after"] = len(ctx.cluster.scheduler().agent_addresses)
        finally:
            port.runtime.shutdown()
            if joined is not None and joined.poll() is None:
                os.killpg(joined.pid, signal.SIGKILL)
            if joined is not None:
                joined.wait(timeout=30)
    faults.refresh_from_env()
    run["left"] = _left(dirs)
    # The dead host's directories hold what it made before it died.
    run["dead_host_left"] = sum(len(v) for v in _left(joined_dirs).values())
    out["failover"] = run
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def pool_ready(root: str, repeats: int = 3) -> int:
    """Print the start-up (``WorkerPool.ready_s``: spawn until every worker
    reported in) of ``repeats`` fresh 8-worker pools of the checkout at
    ``root``, one after the other, as ``POOL <root> ready_s [...]``."""
    sys.path.insert(0, os.path.abspath(root))
    from ray_shuffling_data_loader_tpu_torch.runtime.tasks import WorkerPool

    ready = []
    for _ in range(repeats):
        pool = WorkerPool(8)
        try:
            deadline = time.monotonic() + 120
            while pool.ready_s is None and time.monotonic() < deadline:
                time.sleep(0.005)
            ready.append(pool.ready_s)
        finally:
            pool.shutdown()
    print(f"POOL {root} ready_s {ready!r}")
    return 0 if all(r is not None for r in ready) else 1


def phase_faults(torch, filenames, reference: dict, work: str) -> dict:
    """The fault plane on the slices' dataset, in a head process
    (:func:`faults_head`) with its own shm and spill directories and one
    audit spool. Held against ``reference`` (the ``[cluster]`` phase's
    audited, deterministic one-host DLRM run): the recovered run and the
    failover run must stage its tensors and train its losses bit for bit,
    each epoch reconcile ``ok`` with every row mapped, reduced, delivered
    and consumed; the recovered run's schedule must have fired each kind
    (map crashes and reduce crashes in both epochs, a worker's death, a lost
    object re-made from lineage, the driver's reset) and K1 launch once a
    step on its tensor-core route; ``replay`` of its journal must exit 0
    with the schedule re-armed; the poison must raise ``StageFailedError``
    (map, epoch 0, 3 attempts) within ``POISON_BOUND_S`` with the stager's
    pinned ring and side stream released; failover must evict the dead
    host and re-make its segments; no segment may be left."""
    t_phase = time.perf_counter()
    tag = f"rsdl-faults-{os.getpid()}"
    dirs = {"RSDL_SHM_DIR": f"/dev/shm/{tag}-head", "RSDL_SPILL_DIR": os.path.join(work, "spill-head")}
    spec = {
        "files": filenames, "work": work, "result": os.path.join(work, "result.json"),
        "spool": os.path.join(work, "spool"), "journal": os.path.join(work, "journal"),
        "journal_failover": os.path.join(work, "journal-failover"),
        "joined_shm": f"/dev/shm/{tag}-joined", "joined_spill": os.path.join(work, "spill-joined"),
    }
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env.update(dirs, RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_AUDIT="1")
    head = start_head("faults", spec, env)
    try:
        code = head.wait(timeout=600)
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()
        for d in (dirs["RSDL_SHM_DIR"], spec["joined_shm"]):
            shutil.rmtree(d, ignore_errors=True)
    if code != 0:
        raise AssertionError(f"[faults] the head exited {code}")
    with open(spec["result"]) as f:
        res = json.load(f)

    def same_as_reference(label: str) -> None:
        run = res[label]
        for v in run["verdicts"]:
            rows = [v[k] for k in ("rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed")]
            if v["ok"] is not True or v["mismatch"] or rows != [NUM_ROWS] * 4:
                raise AssertionError(f"[faults] {label}: epoch {v['epoch']} verdict {v}")
        if [v["epoch"] for v in run["verdicts"]] != [0, 1]:
            raise AssertionError(f"[faults] {label}: verdicts {run['verdicts']}")
        for got, want in zip(run["verdicts"], reference["verdicts"]):
            if got["delivered_seq"] != want["delivered_seq"]:
                raise AssertionError(f"[faults] {label}: epoch {want['epoch']} delivered_seq {got['delivered_seq']} "
                                     f"against the reference's {want['delivered_seq']}")
        if run["digests"] != reference["digests"]:
            raise AssertionError(f"[faults] {label}: other staged tensors than the reference's")
        if run["losses"] != reference["losses"]:
            diff = max(abs(a - b) for a, b in zip(run["losses"], reference["losses"]))
            raise AssertionError(f"[faults] {label}: losses differ from the reference's by up to {diff!r}")
        n = run["launches"]
        if (n["interaction"] != run["steps"] or n["interaction_mma"] != run["steps"]
                or any(v for k, v in n.items() if not k.startswith("interaction"))):
            raise AssertionError(f"[faults] {label}: launches {n} in {run['steps']} steps")
        if run["left"]:
            raise AssertionError(f"[faults] {label}: segments left after shutdown: {run['left']}")

    rec = res["recovered"]
    same_as_reference("recovered")
    log_ = rec["recovery"]["recovery_log"] or []
    kinds = {}
    for e in log_:
        kinds.setdefault((e["epoch"], e["stage"], e.get("error")), 0)
        kinds[(e["epoch"], e["stage"], e.get("error"))] += 1
    for epoch in (0, 1):
        for stage in ("map", "reduce"):
            if not kinds.get((epoch, stage, "FaultInjected")):
                raise AssertionError(f"[faults] recovered: no crashed {stage} in epoch {epoch}: {kinds}")
    deaths = sum(v for k, v in kinds.items() if k[2] == "WorkerDied")
    lost = sum(v for k, v in kinds.items() if k[2] == "ObjectLostError")
    remade = (rec["recovery"]["rematerialized"] or {}).get("map", 0)
    if not deaths or rec["pool_deaths"] < 1:
        raise AssertionError(f"[faults] recovered: no worker died in a reduce: {kinds}, deaths {rec['pool_deaths']}")
    if not lost or not remade:
        raise AssertionError(f"[faults] recovered: no object lost and re-made: {kinds}, {rec['recovery']}")
    if rec["driver_fired"].get("transport.send:reset") != 1:
        raise AssertionError(f"[faults] recovered: the driver's reset did not fire: {rec['driver_fired']}")
    retries = rec["recovery"]["stage_retries"]
    log(f"[faults] recovered: the reference's {len(rec['digests'])} staged batches and {len(rec['losses'])} losses "
        f"bit for bit; both epochs ok at {NUM_ROWS} rows; retries {retries}, re-made {rec['recovery']['rematerialized']}"
        f", by (epoch, stage, error) {kinds}; workers died {rec['pool_deaths']}; driver {rec['driver_fired']}")
    log(f"[faults] recovered against the reference: shuffle s per epoch {rec['epoch_shuffle_s']!r} against "
        f"{reference['epoch_shuffle_s']!r}; step median {rec['step_ms_median']!r} against "
        f"{reference['step_ms_median']!r} ms; stall share {rec['stall_share']!r} against {reference['stall_share']!r}")

    rep = res["replay"]
    if rep["code"] != 0:
        raise AssertionError(f"[faults] replay exited {rep['code']}: {rep['stderr']}")
    report = rep["report"]
    if (sorted(report["epochs"]) != ["0", "1"] or not all(e["ok"] for e in report["epochs"].values())
            or report["faults"]["spec"] != FAULTS_SPEC or report["faults"]["seed"] != str(FAULTS_SEED)):
        raise AssertionError(f"[faults] replay report: {report}")
    log(f"[faults] replay: both epochs reproduced (exit 0) under the re-armed schedule in {rep['s']!r} s; the "
        f"replay's driver fired {report['faults']['fired']}")

    poison = res["poison"]
    if (poison.get("raised"), poison.get("stage"), poison.get("epoch"), poison.get("attempts")) != (
            "StageFailedError", "map", 0, 3):
        raise AssertionError(f"[faults] poison: {poison}")
    if poison["s"] > POISON_BOUND_S or not poison["released"] or poison["left"]:
        raise AssertionError(f"[faults] poison: {poison}")
    log(f"[faults] poison: StageFailedError(map, epoch 0, 3 attempts) reached the trainer in {poison['s']!r} s "
        f"(bound {POISON_BOUND_S}); pinned ring and side stream released; no segment left")

    fo = res["failover"]
    same_as_reference("failover")
    fo_remade = (fo["recovery"]["rematerialized"] or {}).get("map", 0)
    if fo["killed_after_s"] is None or len(fo["hosts_after"]) != 1 or fo["agents_after"] != 1 or not fo_remade:
        raise AssertionError(f"[faults] failover: killed after {fo['killed_after_s']} s, hosts after "
                             f"{fo['hosts_after']}, agents {fo['agents_after']}, recovery {fo['recovery']}")
    log(f"[faults] failover: joined host SIGKILLed {fo['killed_after_s']!r} s into the run, after epoch 0's maps; "
        f"evicted (hosts after: {fo['hosts_after']}); {fo_remade} maps re-made from lineage, retries "
        f"{fo['recovery']['stage_retries']}; the reference's tensors and losses bit for bit; shuffle s per epoch "
        f"{fo['epoch_shuffle_s']!r}; the dead host left {fo['dead_host_left']} segments in its own directories")
    for r in (rec, fo):
        r.pop("digests", None)
    res["launches"] = rec["launches"]
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[faults] phase {res['wall_s']:.1f} s")
    return res


PLAN_ROW_GROUPS = 20  # at 8 reducers, >= 2R row groups a file: the planner's block:1
PLAN_KNOBS = ("RSDL_PLAN", "RSDL_SHUFFLE_PLAN", "RSDL_SELECTIVE_READS", "RSDL_DECODE_PUSHDOWN",
              "RSDL_DECODE_CACHE_SHARED", "RSDL_INDEX_SHUFFLE")
# (label, environment, cache_decoded, key staged): the DLRM runs of the
# plan phase, in pairs held bit-identical: each planned run and the same
# terms set by hand, and the layout's projection against the full decode.
PLAN_DLRM_RUNS = (
    ("planned_cache", {"RSDL_PLAN": "auto"}, True, True),
    ("hand_cache", {"RSDL_SHUFFLE_PLAN": "block:1", "RSDL_SELECTIVE_READS": "off", "RSDL_DECODE_PUSHDOWN": "on"},
     True, True),
    ("planned_nocache", {"RSDL_PLAN": "auto"}, False, True),
    ("hand_nocache", {"RSDL_SHUFFLE_PLAN": "block:1", "RSDL_SELECTIVE_READS": "on", "RSDL_DECODE_PUSHDOWN": "on"},
     False, True),
    ("pushdown_on", {"RSDL_DECODE_PUSHDOWN": "on"}, None, False),
    ("pushdown_off", {"RSDL_DECODE_PUSHDOWN": "off"}, None, False),
)
PLAN_PAIRS = (("planned_cache", "hand_cache"), ("planned_nocache", "hand_nocache"), ("pushdown_on", "pushdown_off"))
NARROW_PROJECTION = ["key", "labels"] + [f"embeddings_name{i}" for i in range(8)]


# The metered run's fault schedule: one map crash in epoch 1 in each pool
# worker that takes an epoch-1 map (seeded; the budget of 8 rides out a
# retry that meets another worker's unspent rule).
TELEMETRY_FAULTS = "task.map:crash:1@1x1"
TELEMETRY_SEED = 16
TELEMETRY_ATTEMPTS = 8
PLANE_VARS = ("RSDL_METRICS", "RSDL_TRACE", "RSDL_TRACE_DIR", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_TS",
              "RSDL_TS_PERIOD_S", "RSDL_PROFILE", "RSDL_PROFILE_DIR", "RSDL_RUN_LEDGER", "RSDL_PLAN")
# The temporal and decision planes as the metered run arms them: the time
# series every half second, the profiler at its default 67 Hz.
TS_PERIOD_S = "0.5"
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})? '
    r'(-?[0-9]+(\.[0-9]*)?([eE][-+]?[0-9]+)?|NaN|[-+]Inf)$'
)
MAP_STAGES = ("map", "plan")
REDUCE_STAGES = ("reduce", "gather-reduce", "selective-reduce")


def _planes_env(spool: str) -> dict:
    """Every plane on, spooling under ``spool``."""
    return {"RSDL_METRICS": "1", "RSDL_TRACE": "1", "RSDL_TRACE_DIR": os.path.join(spool, "trace"),
            "RSDL_METRICS_DIR": os.path.join(spool, "metrics"), "RSDL_EVENTS_DIR": os.path.join(spool, "events"),
            "RSDL_TS": "1", "RSDL_TS_PERIOD_S": TS_PERIOD_S, "RSDL_PROFILE": "1",
            "RSDL_PROFILE_DIR": os.path.join(spool, "profiles"), "RSDL_RUN_LEDGER": os.path.join(spool, "runs.ndjson")}


def _planes(port, env: dict, clear=PLANE_VARS):
    """The planes as ``env`` says, each cached flag of this process read
    again and its buffers and views dropped."""
    from ray_shuffling_data_loader_tpu_torch import telemetry
    from ray_shuffling_data_loader_tpu_torch.telemetry import (capacity, critical, events, metrics, phases, profiler,
                                                               stragglers, timeseries)

    stack = contextlib.ExitStack()
    stack.enter_context(environment(env, clear=clear))
    for mod in (telemetry, metrics, phases, profiler):
        mod.refresh_from_env()
    telemetry.reset_state()
    for mod in (metrics, events, stragglers, capacity, critical, timeseries, profiler):
        mod.reset()
    return stack


def _spool_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(directory) for f in fs)


def decision_checks(port, flat: dict, t_run: tuple, work: str) -> dict:
    """The temporal and decision planes at the metered run's end, before
    the session shuts down: task records against the task counters, the
    critical path of each epoch and the stalls against the registry, the
    capacity ledger against the store to the byte, the time series, the
    profiles, the run ledger's record and the planner's live signals.
    Raises on a failed check; returns what it read."""
    from ray_shuffling_data_loader_tpu_torch import shuffle
    from ray_shuffling_data_loader_tpu_torch.analysis import planner
    from ray_shuffling_data_loader_tpu_torch.telemetry import (capacity, critical, export, profiler, runledger,
                                                               stragglers, timeseries)

    out = {}
    # Stragglers: one record a returned stage task; a crash at entry none.
    ana = stragglers.analyze()
    counts = {stage: st["count"] for stage, st in ana["stages"].items()}
    maps, reduces = sum(counts.get(s, 0) for s in MAP_STAGES), sum(counts.get(s, 0) for s in REDUCE_STAGES)
    if (maps, reduces) != (flat.get("shuffle.map_tasks"), flat.get("shuffle.reduce_tasks")) or ana["wedged"]:
        raise AssertionError(f"[telemetry] task records {counts} (map {maps}, reduce {reduces}) against counters "
                             f"{flat.get('shuffle.map_tasks')} / {flat.get('shuffle.reduce_tasks')}; wedged "
                             f"{ana['wedged']}")
    out["stragglers"] = {"counts": counts, "skew": {s: st["skew_ratio"] for s, st in ana["stages"].items()},
                         "median_s": {s: st["median_s"] for s, st in ana["stages"].items()},
                         "flagged": ana["flagged_total"]}
    # The critical path: a row an epoch, on a stage that ran in it; the
    # stalls by cause are the registry's.
    crit = critical.analyze()
    rows = {r["epoch"]: r for r in crit["epochs"]}
    stall = {}
    for key, value in flat.items():
        if key.startswith("stall_seconds{"):
            labels = dict(part.partition("=")[::2] for part in key[len("stall_seconds{"):-1].split(","))
            stall[labels["cause"]] = stall.get(labels["cause"], 0.0) + value
    if (sorted(rows) != [0, 1] or any(r["critical_path"] not in MAP_STAGES + REDUCE_STAGES for r in rows.values())
            or crit["stall_by_cause"] != stall):
        raise AssertionError(f"[telemetry] critical: rows {[(e, r['critical_path']) for e, r in rows.items()]}, "
                             f"stalls {crit['stall_by_cause']} against the registry's {stall}")
    out["critical"] = {"paths": {e: r["critical_path"] for e, r in rows.items()},
                       "sole_share": {e: r["sole_share"] for e, r in rows.items()}, "stall_by_cause": stall,
                       "run": crit["run_critical_path"]}
    # Capacity: the fold by tier against the store, to the byte; the cache
    # tier holds the shared decode cache's segments.
    folded, stats = capacity.ledger(), port.runtime.store_stats()
    totals = folded["totals"]
    resident = {t: c["resident_bytes"] for t, c in totals.items()}
    cached = shuffle._shared_cache_spared()
    if (resident["shm"] + resident["cache"] != stats.total_bytes - stats.spill_bytes
            or resident["spill"] != stats.spill_bytes or totals["cache"]["segments"] != len(cached)
            or not cached or resident["cache"] != stats.total_bytes
            or any(folded["epochs"].get(str(e), {}).get("shm", {}).get("hwm_bytes", 0) <= 0 for e in range(2))):
        raise AssertionError(f"[telemetry] capacity: fold {resident} ({totals['cache']['segments']} cache segments, "
                             f"{len(cached)} shared) against the store {stats}; epochs {folded['epochs']}")
    out["capacity"] = {"resident": resident, "store": {"objects": stats.num_objects, "bytes": stats.total_bytes},
                       "hwm_bytes": {e: {t: c["hwm_bytes"] for t, c in tiers.items()}
                                     for e, tiers in folded["epochs"].items()},
                       "ops": folded["ops"]}
    # The planner's live signals are those views' at this moment.
    signals, view, now_crit = planner._live_signals(), capacity.view(), critical.analyze()
    if (signals.get("shm_used_frac") != view.get("shm_used_frac") or signals.get("shm_used_frac") is None
            or signals.get("critical_path") != now_crit["current"].get("critical_path")
            or signals.get("critical_path") is None):
        raise AssertionError(f"[telemetry] live signals {signals} against view {view.get('shm_used_frac')} and "
                             f"critical {now_crit['current']}")
    out["live_signals"] = signals
    # The time series: a sample a second of the run or more, no rate below
    # 0, and the persisted file equal to the ring once the sampler stops.
    timeseries.stop()
    ring = timeseries.samples()
    in_run = [x for x in ring if t_run[0] <= x["ts"] <= t_run[1]]
    negative = [k for x in ring for k, e in x["metrics"].items() if e.get("rate", 0.0) < 0]
    if len(in_run) < int(t_run[1] - t_run[0]) or negative or timeseries.load_persisted() != json.loads(
            json.dumps(ring)):
        raise AssertionError(f"[telemetry] time series: {len(in_run)} samples in {t_run[1] - t_run[0]:.1f} s, "
                             f"negative rates {negative[:5]}, persisted {len(timeseries.load_persisted())} "
                             f"against {len(ring)}")
    out["timeseries"] = {"samples": len(ring), "in_run": len(in_run), "run_s": t_run[1] - t_run[0]}
    # The profiles: the driver's and a task worker's, stage-tagged stacks.
    records = profiler.load_records()
    roles = sorted({r["source"]["role"] for r in records})
    digest = profiler.digest()
    stages = set((digest or {}).get("stages") or {})
    if not {"driver", "task"} <= set(roles) or "staging" not in stages or not {"map", "reduce"} & stages:
        raise AssertionError(f"[telemetry] profiles of {roles}; digest stages {sorted(stages)}")
    snap = profiler.snapshot()
    out["profiler"] = {"roles": roles, "sources": digest["sources"], "stages": digest["stages"],
                       "top": digest["top"][:8], "driver_samples": snap["samples"],
                       "driver_hz": snap["samples"] / (time.time() - snap["t0"]),
                       "spool_bytes": _spool_bytes(profiler.spool_dir())}
    # The run ledger: one done record with its sections.
    records = runledger.read()
    rec = records[0] if len(records) == 1 else {}
    if (rec.get("status") != "done" or [r.get("state") for r in rec.get("epochs", [])] != ["done", "done"]
            or not rec.get("critical", {}).get("epochs") or not rec.get("capacity", {}).get("shm_resident_bytes")
            or not rec.get("profile")):
        raise AssertionError(f"[telemetry] run ledger: {len(records)} records, {sorted(rec)}: "
                             f"{ {k: rec.get(k) for k in ('status', 'epochs', 'critical', 'capacity')} }")
    out["run_ledger"] = {k: rec[k] for k in ("id", "status", "duration_s", "epochs", "critical", "capacity",
                                             "stall_by_cause")}
    out["run_ledger"]["bytes"] = os.path.getsize(runledger.ledger_path())
    # What a tick costs here: the profiler's fold of every thread, and the
    # time series' refresh of the derived gauges with its sample.
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        profiler._tick()
    out["profiler"]["tick_us"] = (time.perf_counter() - t0) / n * 1e6
    out["profiler"]["threads"] = threading.active_count()
    t0 = time.perf_counter()
    for _ in range(5):
        stragglers.publish_metrics()
        capacity.publish_metrics()
        critical.publish_metrics()
        export.aggregate_typed(per_source=True)
    out["timeseries"]["tick_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def telemetry_head(spec: dict) -> int:
    """The ``[telemetry]`` phase's runs, in a process of their own started
    with every plane on: the metered DLRM run with its checks; delivery
    only under the plan compiler, with the planes on and with metrics off;
    then delivery only with the planes off, then on. Raises on a
    failed check (the phase then fails); writes the results to
    ``spec["result"]``."""
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch import shuffle, telemetry
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.stats import ObjectStoreStatsCollector
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit, events, export, metrics

    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    files, work, ref = spec["files"], spec["work"], spec["reference"]
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    out = {}

    # (1) The metered run, the fault rule armed before the session starts;
    # the shared decode cache on, so that its segments outlive the run in
    # the capacity ledger's cache tier; audited, for the audit report.
    with environment({"RSDL_FAULTS": TELEMETRY_FAULTS, "RSDL_FAULTS_SEED": str(TELEMETRY_SEED),
                      "RSDL_STAGE_MAX_ATTEMPTS": str(TELEMETRY_ATTEMPTS), "RSDL_DECODE_CACHE_SHARED": "on",
                      "RSDL_AUDIT": "1", "RSDL_AUDIT_DIR": os.path.join(work, "audit")}):
        faults.refresh_from_env()
        audit.refresh_from_env()
        port.runtime.init()
        try:
            log(f"[telemetry] worker pool up in {start_pool(port)!r} s; every plane on (time series every "
                f"{TS_PERIOD_S} s, profiler); schedule {TELEMETRY_FAULTS} seed {TELEMETRY_SEED}, "
                f"{TELEMETRY_ATTEMPTS} attempts")
            with ObjectStoreStatsCollector(sample_period_s=1.0):
                t0 = time.time()
                reset_launches(ops)
                run = cluster_run(torch, port, files, "metered", model, init_state, tag="telemetry")
                run["launches"] = read_launches(ops)
                t_run = (t0, time.time())
            dump_path = metrics.dump_json(os.path.join(work, "metrics.json"))
            with open(os.path.join(work, "audit.json"), "w") as f:
                json.dump(audit.summary(), f)
            typed = export.aggregate_typed()
            flat = export.flatten(typed)
            prom = export.prometheus_text()
            logged = events.load()
            out["decision"] = decision_checks(port, flat, t_run, work)
            shuffle.shared_decode_cache_clear(free=True)
        finally:
            port.runtime.shutdown()
    faults.refresh_from_env()
    audit.refresh_from_env()
    trace_path = telemetry.trace_export(os.path.join(work, "trace.json"))
    with open(trace_path) as f:
        trace = json.load(f)["traceEvents"]
    with open(dump_path) as f:
        dump = json.load(f)

    # Same training: the unmetered one-host run's tensors and losses.
    if run["digests"] != ref["digests"] or run["losses"] != ref["losses"]:
        bad = [i for i, (a, b) in enumerate(zip(run["digests"], ref["digests"])) if a != b]
        raise AssertionError(f"[telemetry] metered run differs from the unmetered one: batches {bad[:5]}, losses "
                             f"{run['losses'][:3]} against {ref['losses'][:3]}")
    n = run["launches"]
    if n["interaction_mma"] != run["steps"] or n["interaction"] != run["steps"] or run["steps"] != 30:
        raise AssertionError(f"[telemetry] launches {n} in {run['steps']} steps: want 30 K1, all tensor-core")
    if [(v["epoch"], v["ok"], v["rows_delivered"]) for v in run["verdicts"]] != [(e, True, NUM_ROWS) for e in (0, 1)]:
        raise AssertionError(f"[telemetry] the metered run's audit: {run['verdicts']}")
    # The counters, over every process's spool.
    retries = run["recovery"]["stage_retries"] or {}
    want = {"shuffle.map_tasks": 20.0, "shuffle.reduce_tasks": 16.0, "h2d.batches": 30.0}
    got = {k: flat.get(k) for k in want}
    if got != want:
        raise AssertionError(f"[telemetry] counters {got}, want {want}")
    for key in ("shuffle.map_rows", "shuffle.reduce_rows"):
        if flat.get(key, 0.0) < 2 * NUM_ROWS:
            raise AssertionError(f"[telemetry] {key} {flat.get(key)} < {2 * NUM_ROWS}")
    for cause in ("upstream", "staging"):
        if metrics.format_key("stall_seconds", {"cause": cause}) not in flat:
            raise AssertionError(f"[telemetry] no stall_seconds{{cause={cause}}}")
    phase_stages = {k.split("stage=")[1].split("}")[0] for k in typed if k.startswith("shuffle.phase_seconds{")}
    if not {"map", "reduce"} <= phase_stages:
        raise AssertionError(f"[telemetry] phase times of the stages {sorted(phase_stages)}")
    # Recovery: the counters equal the run's stats, the events one a retry.
    metered_retries = export.labeled_sum(flat, "recovery.stage_retries")[1]
    injected = export.labeled_sum(flat, "faults.injected")
    kinds = {k: sum(1 for e in logged if e["kind"] == k) for k in ("stage.retry", "epoch.done", "recovery")}
    if (not retries.get("map") or metered_retries.get("{stage=map}") != float(retries["map"])
            or sum(metered_retries.values()) != float(sum(retries.values())) or injected[0] < 1
            or kinds["stage.retry"] != sum(retries.values()) or kinds["epoch.done"] != 2):
        raise AssertionError(f"[telemetry] recovery: stats {retries}, counters {metered_retries}, injected "
                             f"{injected}, events {kinds}")
    # The trace.
    head_pid = os.getpid()
    spans = [e for e in trace if e.get("ph") == "X"]

    def epochs(name, pids=None):
        return {e["args"].get("epoch") for e in spans if e["name"] == name and (pids is None or pids(e["pid"]))}

    checks = {
        "map": epochs("map", lambda p: p != head_pid), "reduce": epochs("reduce", lambda p: p != head_pid),
        "epoch:admission": epochs("epoch:admission", lambda p: p == head_pid),
        "actor:new_epoch": epochs("actor:new_epoch", lambda p: p != head_pid), "stage:h2d": epochs("stage:h2d"),
    }
    if any(not {0, 1} <= got for got in checks.values()):
        raise AssertionError(f"[telemetry] trace: epochs of each span {checks}")
    # The Prometheus text and the dump.
    bad = [ln for ln in prom.splitlines() if not ln.startswith(("# HELP ", "# TYPE ", "# Prometheus"))
           and not PROM_SAMPLE.match(ln)]
    if bad or not prom.endswith("\n"):
        raise AssertionError(f"[telemetry] Prometheus lines that do not parse: {bad[:5]}")
    if "queue.depth.total" not in dump["final"] or not any("queue.depth.total" in x["values"]
                                                          for x in dump["samples"]):
        raise AssertionError(f"[telemetry] dump: final {sorted(dump['final'])[:20]}, {len(dump['samples'])} samples")
    spools = {plane: _spool_bytes(os.environ[var])
              for plane, var in (("trace", "RSDL_TRACE_DIR"), ("metrics", "RSDL_METRICS_DIR"),
                                 ("events", "RSDL_EVENTS_DIR"), ("profiles", "RSDL_PROFILE_DIR"))}
    out["metered"] = {
        **{k: run[k] for k in ("losses", "launches", "steps", "step_ms_median", "epoch_s", "epoch_shuffle_s",
                               "stall_s", "stall_share", "recovery", "schedules")},
        "counters": {k: flat.get(k) for k in ("shuffle.map_tasks", "shuffle.map_rows", "shuffle.reduce_tasks",
                                              "shuffle.reduce_rows", "h2d.batches", "h2d.bytes")},
        "stage_retries": metered_retries, "faults_injected": injected[1], "events": kinds,
        "trace_events": len(trace), "spool_bytes": spools, "samples": len(dump["samples"]),
        "prometheus_lines": len(prom.splitlines()),
        "verdicts": [{k: v[k] for k in ("epoch", "ok", "rows_mapped", "rows_delivered")} for v in run["verdicts"]],
    }
    dec = out["decision"]
    log(f"[telemetry] metered: tensors and {len(run['losses'])} losses equal the unmetered run's; K1 "
        f"{n['interaction_mma']} of {run['steps']} steps on the tensor-core route; schedules {run['schedules']}; "
        f"counters {out['metered']['counters']}; stage retries {metered_retries} = stats {retries}; faults.injected "
        f"{injected[1]}; events {kinds}")
    log(f"[telemetry] trace: {len(trace)} events, span epochs {checks}; spool bytes {spools}; Prometheus "
        f"{out['metered']['prometheus_lines']} lines parse; {len(dump['samples'])} samples")
    log(f"[telemetry] stragglers: task records {dec['stragglers']['counts']} = the counters; median s "
        f"{dec['stragglers']['median_s']}; skew {dec['stragglers']['skew']}; flagged {dec['stragglers']['flagged']}; "
        f"none wedged")
    log(f"[telemetry] critical path by epoch {dec['critical']['paths']} (run {dec['critical']['run']}), sole shares "
        f"{dec['critical']['sole_share']}; stalls by cause {dec['critical']['stall_by_cause']} = the registry's")
    log(f"[telemetry] capacity at the run's end: fold {dec['capacity']['resident']} B = the store's "
        f"{dec['capacity']['store']}; high watermarks {dec['capacity']['hwm_bytes']}; {dec['capacity']['ops']} ops; "
        f"live signals {dec['live_signals']} = capacity.view() and critical.analyze()")
    log(f"[telemetry] time series: {dec['timeseries']['in_run']} samples in the run's "
        f"{dec['timeseries']['run_s']:.1f} s ({dec['timeseries']['samples']} in all), no negative rate, persisted = "
        f"ring; a tick's refresh and aggregate {dec['timeseries']['tick_ms']:.3f} ms")
    log(f"[telemetry] profiler: roles {dec['profiler']['roles']}, {dec['profiler']['sources']} sources, stages "
        f"{dec['profiler']['stages']}; driver {dec['profiler']['driver_samples']} samples at "
        f"{dec['profiler']['driver_hz']:.1f} Hz, a tick {dec['profiler']['tick_us']:.1f} us over "
        f"{dec['profiler']['threads']} threads; top {dec['profiler']['top'][:4]}")
    log(f"[telemetry] run ledger: {dec['run_ledger']}")

    # (2) Re-planning on live signals: delivery only, 3 epochs under the
    # plan compiler, the planes on, then metrics off (no signal, no
    # re-plan); the staged tensors must be the same.
    out["replan"] = {}
    for label, on in (("planes-on", True), ("metrics-off", False)):
        env = {**(_planes_env(os.path.join(work, "replan")) if on else {}), "RSDL_PLAN": "auto"}
        with _planes(port, env):
            port.runtime.init()
            try:
                start_pool(port)
                r = cluster_run(torch, port, files, f"replan-{label}", tag="telemetry", epochs=3)
            finally:
                port.runtime.shutdown()
        out["replan"][label] = {"digests": r["digests"], "plan_replans": r["plan_replans"],
                                "plan_terms": {k: v["value"] for k, v in (r["plan_terms"] or {}).items()},
                                "epoch_shuffle_s": r["epoch_shuffle_s"]}
    on_run, off_run = out["replan"]["planes-on"], out["replan"]["metrics-off"]
    if on_run.pop("digests") != off_run.pop("digests") or off_run["plan_replans"]:
        raise AssertionError(f"[telemetry] re-planned delivery differs from the unplanned-signal one, or replanned "
                             f"without signals: {off_run['plan_replans']}")
    log(f"[telemetry] re-planning: 3 epochs under RSDL_PLAN=auto bit-identical with the planes on and metrics off; "
        f"plan_replans on {on_run['plan_replans']}, off {off_run['plan_replans']}; terms {on_run['plan_terms']}")

    # (3) The cost: delivery only, every plane off, then on.
    out["cost"] = []
    for i, on in enumerate((False, True)):
        with _planes(port, _planes_env(os.path.join(work, f"cost-{i}")) if on else {}):
            port.runtime.init()
            try:
                pool_s = start_pool(port)
                cost = cluster_run(torch, port, files, f"cost-{'on' if on else 'off'}-{i}", tag="telemetry")
            finally:
                port.runtime.shutdown()
        if cost["digests"] != ref["digests"]:
            raise AssertionError(f"[telemetry] cost run {i}: staged tensors differ from the reference's")
        out["cost"].append({"on": on, "epoch_shuffle_s": cost["epoch_shuffle_s"], "epoch_s": cost["epoch_s"],
                            "pool_s": pool_s})
    log("[telemetry] cost, shuffle s per epoch (delivery only): " + "; ".join(
        f"{'on' if c['on'] else 'off'} {c['epoch_shuffle_s']!r}" for c in out["cost"]))
    out["wall_s"] = time.perf_counter() - t_phase
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def run_tool(name: str, *args: str) -> tuple:
    """``python -m ray_shuffling_data_loader_tpu_torch.<name> *args`` as a
    user runs a reporting tool, with no ``RSDL_*`` variable set:
    ``(exit code, stdout, stderr)``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    proc = subprocess.run([sys.executable, "-m", f"ray_shuffling_data_loader_tpu_torch.{name}", *args],
                          capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    return proc.returncode, proc.stdout, proc.stderr


def telemetry_tools(work: str, res: dict) -> dict:
    """The four reporting tools over the metered run's artifacts under
    ``work``, each of which must exit 0 with the run's own figures: the
    epoch report (trace, events, task records, time series, capacity
    ledger, profiles) a row per epoch, the critical path, every task record
    the head counted, a capacity row for both epochs and the profiles'
    frames; the run ledger one record, the head's; the profiler's
    top table; the audit report the run's verdicts."""
    out, secs = {}, {}

    def tool(name, *args):
        t0 = time.perf_counter()
        code, stdout, stderr = run_tool(name, *args)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"[telemetry] {name} {' '.join(args)} exited {code}: {stderr[-2000:]}")
        return stdout

    metered, dec = res["metered"], res["decision"]
    spool = lambda *p: os.path.join(work, *p)  # noqa: E731
    report = json.loads(tool("epoch_report", "--trace", spool("trace.json"), "--events", spool("events"),
                             "--task-records", spool("metrics", "tasks"), "--timeseries", spool("metrics"),
                             "--capacity", spool("metrics"), "--profile", spool("profiles"), "--json"))
    rows = {r["epoch"]: r for r in report["epochs"]}
    tasks = sum(r["tasks"] for r in report.get("stragglers", []))
    cap_epochs = {r["epoch"] for r in report.get("capacity", [])}
    if (not {0, 1} <= set(rows) or any(not rows[e].get("critical_path") for e in (0, 1))
            or not report["header"].get("critical_path") or tasks < sum(dec["stragglers"]["counts"].values())
            or not {"0", "1"} <= cap_epochs or not report.get("profile", {}).get("top")
            or report["header"]["events_by_kind"].get("stage.retry") != metered["events"]["stage.retry"]):
        raise AssertionError(f"[telemetry] epoch_report: epochs {sorted(rows)}, header {report['header']}, "
                             f"{tasks} task records against {dec['stragglers']['counts']}, capacity epochs "
                             f"{sorted(cap_epochs)}, profile {report.get('profile')}")
    out["epoch_report"] = {"critical_path": {e: rows[e]["critical_path"] for e in (0, 1)},
                           "run_critical_path": report["header"]["critical_path"], "task_records": tasks,
                           "capacity_rows": len(report["capacity"]), "profile_samples": report["profile"]["samples"]}
    ledger = spool("runs.ndjson")
    listed = tool("run_ledger", "--ledger", ledger, "list").strip().splitlines()
    shown = json.loads(tool("run_ledger", "--ledger", ledger, "show", "-1"))
    want = dec["run_ledger"]
    if (len(listed) != 1 or want["id"] not in listed[0] or " done " not in listed[0] or shown["id"] != want["id"]
            or shown["duration_s"] != want["duration_s"] or shown["status"] != "done"):
        raise AssertionError(f"[telemetry] run_ledger: list {listed}; show {shown.get('id')} "
                             f"{shown.get('status')} {shown.get('duration_s')}; the head's record {want['id']}")
    out["run_ledger"] = {"records": len(listed), "id": shown["id"]}
    top = json.loads(tool("rsdl_prof", "top", "--dir", spool("profiles"), "--json"))
    if not top["top"] or not top["samples"] or top["sources"] < 2:
        raise AssertionError(f"[telemetry] rsdl_prof top: {top}")
    # rsdl-lint: disable=vocabulary-drift -- named after the profiler CLI
    # module, rsdl_prof: a key of this phase's result, not a metric
    out["rsdl_prof"] = {"samples": top["samples"], "sources": top["sources"], "top": top["top"][0]["frame"]}
    audited = json.loads(tool("audit_report", "--audit-json", spool("audit.json"), "--metrics",
                              spool("metrics.json"), "--json"))
    got = [{k: v.get(k) for k in ("epoch", "ok", "rows_mapped", "rows_delivered")} for v in audited["epochs"]]
    if got != metered["verdicts"] or audited["header"].get("audit_ok") is not True:
        raise AssertionError(f"[telemetry] audit_report: {got}, header {audited['header']}; the run's "
                             f"{metered['verdicts']}")
    out["audit_report"] = {"epochs": got}
    out["seconds"] = secs
    log(f"[telemetry] tools over the metered run's artifacts, each exit 0: epoch_report critical path "
        f"{out['epoch_report']['critical_path']} (run {out['epoch_report']['run_critical_path']}), {tasks} task "
        f"records (the head counted {sum(dec['stragglers']['counts'].values())}), {len(report['capacity'])} "
        f"capacity rows, {report['profile']['samples']} profile samples; run_ledger one record, {shown['id']}; "
        f"rsdl_prof top {out['rsdl_prof']}; audit_report {[(v['epoch'], v['ok']) for v in got]} = the run's "
        f"verdicts; s per tool {secs}")
    return out


def phase_telemetry(torch, filenames, reference: dict, unmetered: dict, work: str) -> dict:
    """The ``[telemetry]`` phase: :func:`telemetry_head` in a process of its
    own, started with every plane on and the spools under ``work``.
    ``reference``: the cluster phase's deterministic one-host DLRM run;
    ``unmetered``: the slices phase's DLRM run, logged beside."""
    t_phase = time.perf_counter()
    spec = {"files": filenames, "work": work, "result": os.path.join(work, "result.json"),
            "reference": {"digests": reference["digests"], "losses": reference["losses"]}}
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env.update(_planes_env(work))
    head = start_head("telemetry", spec, env)
    try:
        code = head.wait(timeout=600)
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()
    if code != 0:
        raise AssertionError(f"[telemetry] the head exited {code}")
    with open(spec["result"]) as f:
        res = json.load(f)
    metered = res["metered"]
    log(f"[telemetry] metered against unmetered DLRM slice: shuffle s per epoch {metered['epoch_shuffle_s']!r} "
        f"against {unmetered['delivery']['epoch_shuffle_s']!r} (the cluster phase's one-host run: "
        f"{reference['epoch_shuffle_s']!r}); step median {metered['step_ms_median']!r} against "
        f"{unmetered['step_ms_median']!r} ms (cluster one host {reference['step_ms_median']!r}); stall share "
        f"{metered['stall_share']!r} against {stall_share(unmetered)!r}; epochs {metered['epoch_s']!r} against "
        f"{unmetered['epoch_s']!r} s")
    res["tools"] = telemetry_tools(work, res)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[telemetry] phase {res['phase_s']:.1f} s (head {res['wall_s']:.1f} s)")
    return res


# The obs phase: the SLO engine, the relay and the obs server on a two-host
# cluster whose session owners each keep their own spools. One user rule
# that must fire while maps run; the default pack's that must not.
OBS_RULE = {"name": "map_rows_flowing", "kind": "threshold", "metric": "shuffle.map_rows", "op": ">", "value": 0}
OBS_QUIET = ("wedged_worker", "audit_mismatch", "capacity_near_limit")
OBS_WORKERS = 4
OBS_LIVE_ROUTES = ("/metrics", "/healthz", "/status", "/alerts")
OBS_JSON_ROUTES = ("/healthz", "/status", "/alerts", "/stragglers", "/capacity", "/critical",
                   "/timeseries?name=shuffle.map_rows", "/events?limit=50", "/profile?top=5", "/jobs")


def _obs_get(port_num: int, route: str):
    """``(status, body, client seconds)`` of one GET on the obs server."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port_num}{route}", timeout=30) as resp:
        body = resp.read().decode()
        return resp.status, body, time.perf_counter() - t0


def _obs_scraper(port_num: int, stop: threading.Event, scrapes: list) -> None:
    """Scrape the live routes about once a second until ``stop``; keeps each
    scrape's status, seconds and, for ``/status``, the providers' epochs and
    depths, for ``/metrics`` the server's own scrape seconds."""
    while True:
        for route in OBS_LIVE_ROUTES:
            try:
                code, body, secs = _obs_get(port_num, route)
            except Exception as exc:  # a failed scrape is a failed check
                scrapes.append({"route": route, "error": repr(exc)})
                continue
            rec = {"route": route, "code": code, "s": secs}
            if route == "/status":
                providers = json.loads(body)["providers"]
                rec["shuffle_in_flight"] = (providers.get("shuffle") or {}).get("in_flight_epochs")
                rec["queue"] = {k: (providers.get("batch_queue") or {}).get(k) for k in ("in_flight_epochs", "depths")}
            elif route == "/metrics":
                rec["server_s"] = float(re.search(r"^rsdl_obs_scrape_duration_seconds (\S+)$", body, re.M).group(1))
            scrapes.append(rec)
        if stop.wait(1.0):
            return


def obs_head(spec: dict) -> int:
    """The ``[obs]`` phase's head, a process of its own started with the
    planes, the relay and ``RSDL_OBS_PORT`` set: a cluster (``init_cluster``)
    that a host joins, the deterministic DLRM slice on it while a thread
    scrapes the server, then the checks that read the head's spools, views
    and pages. Raises on a failed check; writes what it read to
    ``spec["result"]``."""
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit, export, relay, runledger, slo

    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    files, port_num = spec["files"], spec["obs_port"]
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    out = {}
    t0 = time.perf_counter()
    ctx = port.runtime.init_cluster(advertise_host="127.0.0.1", num_workers=OBS_WORKERS)
    try:
        with open(spec["addr"] + ".tmp", "w") as f:
            f.write(ctx.cluster.address)
        os.replace(spec["addr"] + ".tmp", spec["addr"])
        deadline = time.monotonic() + 60
        while len(port.runtime.cluster_hosts()) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("[obs] the second host did not join")
            time.sleep(0.05)
        hosts = ctx.cluster.registry.call("hosts")
        for info in hosts.values():  # each agent's pool up before the epochs
            ActorHandle(tuple(info["agent"])).call("submit", os.getpid, (), {})
        other = next(h for h in hosts if h != ctx.cluster.host_id)
        out["up_s"] = time.perf_counter() - t0
        stop, scrapes = threading.Event(), []
        scraper = threading.Thread(target=_obs_scraper, args=(port_num, stop, scrapes), daemon=True)
        scraper.start()
        try:
            reset_launches(ops)
            run = cluster_run(torch, port, files, "two hosts, split spools", model, init_state, tag="obs")
            run["launches"] = read_launches(ops)
        finally:
            stop.set()
            scraper.join(timeout=30)
        # (1) The run: the one host's tensors and losses, K1 once a step.
        ref = spec["reference"]
        if run["digests"] != ref["digests"] or run["losses"] != ref["losses"]:
            bad = [i for i, (a, b) in enumerate(zip(run["digests"], ref["digests"])) if a != b]
            raise AssertionError(f"[obs] the run differs from the one host's: batches {bad[:5]}, losses "
                                 f"{run['losses'][:3]} against {ref['losses'][:3]}")
        n = run["launches"]
        if n["interaction_mma"] != run["steps"] or n["interaction"] != run["steps"] or run["steps"] != 30:
            raise AssertionError(f"[obs] launches {n} in {run['steps']} steps: want 30 K1, all tensor-core")
        # (2) The audit at the head: the joined host's map and reduce records
        # reach its spool only through the relay (its own audit directory is
        # another). Waits for the last ships, as a reader of the head would.
        marker = relay._safe_host(other)
        spool = audit.spool_dir()
        t_wait, verdicts = time.perf_counter(), []
        while time.perf_counter() - t_wait < 45:
            remote = [f for f in os.listdir(spool) if f.startswith(f"audit-{marker}-")]
            verdicts = audit.reconcile(range(2)) if remote else []
            if len(verdicts) == 2 and all(v.get("ok") is True for v in verdicts):
                break
            time.sleep(0.25)
        for v in verdicts:
            rows = [v[k] for k in ("rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed")]
            if v["ok"] is not True or v["mismatch"] or rows != [NUM_ROWS] * 4:
                raise AssertionError(f"[obs] epoch {v['epoch']} verdict {v}")
        if [v["epoch"] for v in verdicts] != [0, 1] or not remote:
            raise AssertionError(f"[obs] verdicts {verdicts}; the joined host's audit files at the head {remote}")
        out["audit"] = {"wait_s": time.perf_counter() - t_wait, "remote_files": len(remote),
                        "in_run_ok": [v.get("ok") for v in run["verdicts"]],
                        "rows": {k: verdicts[0][k] for k in ("rows_mapped", "rows_reduced", "rows_delivered")}}
        # (3) The aggregate: both hosts' sources, the counters the run's.
        records = export.load_records()
        sources = {str((r.get("source") or {}).get("host")) for r in records}
        relayed = [r for r in records if (r.get("source") or {}).get("relayed")]
        flat = export.aggregate()
        want = {"shuffle.map_tasks": 20.0, "shuffle.reduce_tasks": 16.0, "h2d.batches": 30.0,
                "shuffle.map_rows": 2.0 * NUM_ROWS, "shuffle.reduce_rows": 2.0 * NUM_ROWS}
        got = {k: flat.get(k) for k in want}
        if other not in sources or len(sources) < 2 or not relayed or got != want:
            raise AssertionError(f"[obs] aggregate: sources {sorted(sources)}, {len(relayed)} relayed; counters "
                                 f"{got}, want {want}")
        # (4) The joined host's task records: one per task its agent ran.
        task_dir = os.path.join(export.spool_dir(), "tasks")
        remote_records = sum(1 for f in os.listdir(task_dir) if f.startswith(f"tasks-{marker}-")
                             for line in open(os.path.join(task_dir, f)) if line.strip())
        completed = ActorHandle(tuple(hosts[other]["agent"])).call("agent_stats")["completed"]
        if remote_records != completed or not completed:
            raise AssertionError(f"[obs] the joined host's task records {remote_records}, its agent ran {completed}")
        # (5) The relay's sink: the joined host fresh, bytes shipped, none dropped.
        section = relay.status_section()
        host_rec = section["hosts"].get(other) or {}
        dropped = flat.get("relay.dropped_bytes_total", 0.0)
        if section["role"] != "sink" or host_rec.get("stale") is not False or not host_rec.get("bytes") or dropped:
            raise AssertionError(f"[obs] relay section {section}; dropped {dropped}")
        out["relay"] = {"ships": host_rec["ships"], "bytes": host_rec["bytes"], "skew_s": host_rec["skew_s"],
                        "dropped_bytes": dropped, "lag_bytes": flat.get("relay.lag_bytes")}
        # (6) The pages, once more after the run.
        pages, secs = {}, {}
        code, text, secs["/metrics"] = _obs_get(port_num, "/metrics")
        bad = [ln for ln in text.splitlines()
               if not ln.startswith(("# HELP ", "# TYPE ", "# Prometheus")) and not PROM_SAMPLE.match(ln)]
        if (code != 200 or bad or "\nrsdl_up 1\n" not in text
                or not re.search(r'^rsdl_obs_build_info\{version="0\.1\.0",', text, re.M)):
            raise AssertionError(f"[obs] /metrics: {code}, lines that do not parse {bad[:5]}")
        for route in OBS_JSON_ROUTES:
            code, body, secs[route] = _obs_get(port_num, route)
            if code != 200:
                raise AssertionError(f"[obs] {route}: {code}")
            pages[route] = json.loads(body)
        code, flame, secs["/profile/flame"] = _obs_get(port_num, "/profile/flame")
        if code != 200 or "<html" not in flame.lower():
            raise AssertionError(f"[obs] /profile/flame: {code}")
        health = pages["/healthz"]
        hz_hosts = {s["host"] for s in health["sources"]}
        if (health.get("relay", {}).get("role") != "sink" or other not in health["relay"]["hosts"]
                or other not in hz_hosts or len(hz_hosts) < 2):
            raise AssertionError(f"[obs] /healthz: relay {health.get('relay')}, source hosts {sorted(hz_hosts)}")
        agents = pages["/status"]["cluster"]["agents"]
        if len(agents) != 2:
            raise AssertionError(f"[obs] /status cluster section: {pages['/status']['cluster']}")
        live = [s for s in scrapes if s["route"] == "/status"]
        in_flight = [s for s in live if s.get("shuffle_in_flight")]
        queued = [s for s in live if (s.get("queue") or {}).get("depths") is not None]
        failed = [s for s in scrapes if "error" in s or s.get("code") != 200]
        if failed or not in_flight or not queued:
            raise AssertionError(f"[obs] live scrapes: {len(failed)} failed ({failed[:3]}), {len(live)} of /status, "
                                 f"an epoch of the shuffle in flight in {len(in_flight)}, queue depths in {len(queued)}")
        # (7) rsdl_top over the live server, one frame as JSON, of the run
        # and of the fleet: the pages the phase read.
        out["rsdl_top"] = {}
        for fleet in (False, True):
            t0 = time.perf_counter()
            code, stdout, stderr = run_tool("rsdl_top", "--url", f"http://127.0.0.1:{port_num}", "--once", "--json",
                                            *(["--fleet"] if fleet else []))
            if code != 0:
                raise AssertionError(f"[obs] rsdl_top (fleet {fleet}) exited {code}: {stderr[-2000:]}")
            frame = json.loads(stdout)
            jobs = [j.get("job_id") for j in frame["jobs"].get("jobs", [])]
            if (len(frame["status"]["cluster"]["agents"]) != 2 or frame["healthz"]["relay"]["role"] != "sink"
                    or other not in frame["healthz"]["relay"]["hosts"]
                    or frame["alerts"]["active"] != pages["/alerts"]["active"]
                    or jobs != [j.get("job_id") for j in pages["/jobs"].get("jobs", [])]
                    or frame["stragglers"]["tasks_total"] < pages["/stragglers"]["tasks_total"]):
                raise AssertionError(f"[obs] rsdl_top (fleet {fleet}): agents {frame['status']['cluster']['agents']}, "
                                     f"relay {frame['healthz'].get('relay')}, alerts {frame['alerts'].get('active')}, "
                                     f"jobs {jobs}, tasks {frame['stragglers'].get('tasks_total')}")
            out["rsdl_top"]["fleet" if fleet else "run"] = {"s": time.perf_counter() - t0, "jobs": jobs,
                                                            "pages": sorted(frame)}
        alerts = {r["name"]: r for r in pages["/alerts"]["rules"] if r.get("job") is None}
        loud = [name for name in OBS_QUIET if alerts[name]["active"]]
        ledger = runledger.read()
        fired = (ledger[-1].get("alerts_fired") or {}) if ledger else {}
        if (not alerts[OBS_RULE["name"]]["active"] or loud or fired.get(OBS_RULE["name"]) != 1
                or slo.fired_counts().get(OBS_RULE["name"]) != 1):
            raise AssertionError(f"[obs] alerts: {OBS_RULE['name']} {alerts[OBS_RULE['name']]}, firing among the "
                                 f"quiet {loud}; the run ledger's alerts_fired {fired}")
        scrape = {}
        for s in scrapes:
            if "s" in s:
                scrape.setdefault(s["route"], []).append(s["s"])
        out["scrape"] = {
            "live": {r: {"n": len(v), "median_ms": statistics.median(v) * 1e3, "max_ms": max(v) * 1e3}
                     for r, v in scrape.items()},
            "server_metrics_s": [s["server_s"] for s in scrapes if "server_s" in s],
            "after_run_ms": {r: s * 1e3 for r, s in secs.items()},
        }
        out["run"] = {k: run[k] for k in ("losses", "launches", "steps", "step_ms_median", "epoch_s",
                                          "epoch_shuffle_s", "stall_s", "stall_share", "schedules")}
        out["counters"] = got
        out["remote_task_records"] = remote_records
        out["sources"] = sorted(sources)
        out["alerts"] = {"active": pages["/alerts"]["active"], "fired": slo.fired_counts(), "ledger": fired}
        out["live_status"] = {"scrapes": len(live), "in_flight": [s["shuffle_in_flight"] for s in in_flight],
                              "queue_depths": [s["queue"]["depths"] for s in queued][:4]}
    finally:
        port.runtime.shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def phase_obs(torch, filenames, cluster: dict, work: str) -> dict:
    """The ``[obs]`` phase: :func:`obs_head` and a host joined with ``python
    -m ...runtime.cluster join``, 4 workers each, on one machine. Each
    session owner keeps its own runtime directory, shared-memory and spill
    directories and audit spool; both run with metrics, the audit, the
    profiler and the relay on, and the head serves ``RSDL_OBS_PORT`` with
    the time series every ``TS_PERIOD_S`` and :data:`OBS_RULE` added to the
    SLO rules. ``cluster``: the cluster phase's results (its one-host run is
    the reference; its two-host run, when there is one, is logged beside)."""
    t_phase = time.perf_counter()
    tag = f"rsdl-obs-{os.getpid()}"
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    obs_port = probe.getsockname()[1]
    probe.close()
    single = cluster["single"]
    spec = {"files": filenames, "result": os.path.join(work, "result.json"), "addr": os.path.join(work, "address"),
            "obs_port": obs_port, "reference": {"digests": single["digests"], "losses": single["losses"]}}
    base = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    base.update(RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_METRICS="1", RSDL_AUDIT="1", RSDL_PROFILE="1",
                RSDL_RELAY="auto", RSDL_TS_PERIOD_S=TS_PERIOD_S, RSDL_SLO_RULES=json.dumps([OBS_RULE]))
    envs = {}
    for name in ("head", "joined"):
        os.makedirs(os.path.join(work, f"audit-{name}"))
        envs[name] = {**base, "RSDL_SHM_DIR": f"/dev/shm/{tag}-{name}",
                      "RSDL_SPILL_DIR": os.path.join(work, f"spill-{name}"),
                      "RSDL_AUDIT_DIR": os.path.join(work, f"audit-{name}")}
    envs["head"].update(RSDL_OBS_PORT=str(obs_port), RSDL_RUN_LEDGER=os.path.join(work, "runs.ndjson"))
    procs = {}
    try:
        procs["head"] = start_head("obs", spec, envs["head"])
        deadline = time.monotonic() + 240
        while not os.path.exists(spec["addr"]):
            if procs["head"].poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"[obs] the head exited ({procs['head'].poll()}) or timed out before its address")
            time.sleep(0.05)
        with open(spec["addr"]) as f:
            address = f.read()
        with open(os.path.join(work, "joined.log"), "w") as out_f:
            procs["joined"] = subprocess.Popen(
                [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.runtime.cluster", "join", address,
                 "--num-workers", str(OBS_WORKERS)], env=envs["joined"], cwd=ROOT, stdout=out_f,
                stderr=subprocess.STDOUT)
        for name, proc in procs.items():
            code = proc.wait(timeout=300 if name == "head" else 60)
            if code != 0:
                raise AssertionError(f"[obs] {name} exited {code}; the joined host's log: "
                                     f"{open(os.path.join(work, 'joined.log')).read()[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for env in envs.values():
            shutil.rmtree(env["RSDL_SHM_DIR"], ignore_errors=True)
    with open(spec["result"]) as f:
        res = json.load(f)
    run, two = res["run"], cluster.get("cluster")
    smi = smi_name_and_limit()
    log(f"[obs] two hosts with split spools: the one host's {run['steps']} losses and staged tensors bit for bit; "
        f"K1 {run['launches']['interaction_mma']} of {run['steps']} steps on the tensor-core route; both epochs ok at "
        f"the head ({res['audit']['remote_files']} audit files of the joined host relayed, ok "
        f"{res['audit']['wait_s']:.2f} s after the run; in-run verdicts ok {res['audit']['in_run_ok']}); counters "
        f"{res['counters']} over sources "
        f"{res['sources']}; {res['remote_task_records']} task records of the joined host = its agent's tasks")
    log(f"[obs] relay: {res['relay']['ships']} ships, {res['relay']['bytes']} B from the joined host, dropped "
        f"{res['relay']['dropped_bytes']} B, lag {res['relay']['lag_bytes']} B, clock skew {res['relay']['skew_s']} s "
        f"({smi})")
    log(f"[obs] alerts: active {res['alerts']['active']}, fired {res['alerts']['fired']}, the run ledger's "
        f"alerts_fired {res['alerts']['ledger']}; {res['live_status']['scrapes']} live /status scrapes, the "
        f"shuffle's epochs in flight in them {res['live_status']['in_flight']}, the queue's first depths "
        f"{res['live_status']['queue_depths']}")
    log(f"[obs] rsdl_top --once --json over the live server, exit 0, its pages those read here: "
        + "; ".join(f"{k} {v['s']:.2f} s, jobs {v['jobs']}" for k, v in res["rsdl_top"].items()))
    server_s = res["scrape"]["server_metrics_s"]
    log(f"[obs] scrape ms per route during the run (client, median and max of n): "
        + "; ".join(f"{r} {v['median_ms']:.2f} / {v['max_ms']:.2f} (n {v['n']})"
                    for r, v in res["scrape"]["live"].items())
        + f"; rsdl_obs_scrape_duration_seconds median {statistics.median(server_s) if server_s else None!r}, max "
        f"{max(server_s) if server_s else None!r}; after the run: "
        + "; ".join(f"{r} {ms:.2f}" for r, ms in res["scrape"]["after_run_ms"].items()) + f" ({smi})")
    if two is not None:
        log(f"[obs] step median {run['step_ms_median']!r} ms against the cluster phase's two hosts "
            f"{two['step_ms_median']!r} ms; shuffle s per epoch {run['epoch_shuffle_s']!r} against "
            f"{two['epoch_shuffle_s']!r}; stall share {run['stall_share']!r} against {two['stall_share']!r} ({smi})")
    res["launches"] = run["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[obs] phase {res['phase_s']:.1f} s (head {res['wall_s']:.1f} s, cluster up {res['up_s']:.1f} s; {smi})")
    return res


# The elastic phase: the control loop on a two-host cluster under a store
# budget the run's peak passes. The head's budget is this share of the
# cluster phase's one-host peak (store_stats, sampled by the shuffle): the
# head's own peak was 0.40-0.50 of it (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 5), so placement fills shm to about the budget, over the
# high watermark, and spills the rest.
ELASTIC_WORKERS = 4
ELASTIC_BUDGET_SHARE = 0.4
# The loop's knobs: a tick every 0.2 s (an epoch of the two-host run
# shuffles in about a second once the cache is hot); any live verdict on a
# shuffle stage scales up, once (the cooldown outlasts the run) and never
# down (the one drain is the operator's); an eviction pass at most every
# 0.5 s, and every spilled segment out of the fence dropped in a pass under
# pressure, whatever its age (never a delivered batch: epoch 0's last
# batches still wait in the queue when it leaves the fence). The drop age is
# 0 because the pressure after the fence may come in one pass only, about
# half a second after epoch 0's last reads: with an age of 0.5 s that pass
# found no segment old enough on some machines, and no drop fired.
ELASTIC_ENV = {"RSDL_ELASTIC": "on", "RSDL_ELASTIC_PERIOD_S": "0.2", "RSDL_ELASTIC_UP_THRESHOLD": "0",
               "RSDL_ELASTIC_DOWN_THRESHOLD": "-1", "RSDL_ELASTIC_COOLDOWN_S": "3600", "RSDL_EVICT_COOLDOWN_S": "0.5",
               "RSDL_EVICT_DROP_AGE_S": "0", "RSDL_DRAIN_DEADLINE_S": "60"}
ELASTIC_EVICT_WAIT_REDUCERS = 1  # the operator drains once the loop evicted, or epoch 1 delivered this many


def _elastic_operator(spec: dict, ctl, other: str, hosts: dict, op: dict) -> None:
    """The operator's side of the elastic phase, on a thread of the head:
    once epoch 0 has left the fence and epoch 1 runs, wait for the loop's
    own eviction (until epoch 1 delivered ``ELASTIC_EVICT_WAIT_REDUCERS``
    reducers), scale up by hand if the loop has not, drain the joined host,
    then stop it (SIGINT to its ``join`` process) and take it out of the
    registry again should its heartbeat have put it back."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle
    from ray_shuffling_data_loader_tpu_torch.runtime import cluster as port_cluster
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    def epoch(e):
        return (port_shuffle.live_status().get("epochs") or {}).get(str(e)) or {}

    try:
        deadline = time.monotonic() + 600
        while not (epoch(0).get("state") == "done" and 0 not in port_shuffle.protected_epochs()):
            if time.monotonic() > deadline:
                raise TimeoutError("epoch 0 never left the fence")
            time.sleep(0.005)
        op["epoch0_done_ts"] = time.time()
        while ctl.evicted_bytes == 0:
            e1 = epoch(1)
            if e1.get("delivered_reducers", 0) >= ELASTIC_EVICT_WAIT_REDUCERS or e1.get("state") in ("done", "failed"):
                break
            time.sleep(0.005)
        op["evicted_before_drain"] = ctl.evicted_bytes
        if ctl.scale_events == 0:
            op["scale_up_forced"] = ctl._scale_up(reason="operator: no live verdict on a shuffle stage yet")
        op["epoch1_at_drain"] = epoch(1)
        t0 = time.perf_counter()
        op["outcome"] = ctl.drain_host(ActorHandle(tuple(hosts[other]["agent"])), host_id=other)
        op["drain_s"] = time.perf_counter() - t0
        op["drain_age_after"] = metrics.registry.snapshot().get("elastic.drain_age_seconds")
        op["membership"] = port_cluster.membership_section()
        with open(spec["joined_pid"]) as f:
            os.kill(int(f.read()), signal.SIGINT)
        store = ActorHandle(tuple(hosts[other]["store"]))
        t_stop = time.monotonic()
        while store.ping(timeout=1.0) and time.monotonic() - t_stop < 60:
            time.sleep(0.1)
        op["joined_stopped_s"] = time.monotonic() - t_stop
        ctl._unregister_host(other, tuple(hosts[other]["agent"]))
    except BaseException as exc:  # the head checks op["error"]
        op["error"] = f"{type(exc).__name__}: {exc}"


def elastic_head(spec: dict) -> int:
    """The ``[elastic]`` phase's head, a process of its own started with
    metrics, the strict audit, the elastic loop (:data:`ELASTIC_ENV`) and the
    store's budget: a cluster (``init_cluster``) that a host joins, the
    deterministic DLRM slice on it (the decode cache on) while the operator
    thread (:func:`_elastic_operator`) drains the joined host in epoch 1,
    then the checks that read the head's ledger, events, gauges and store.
    Raises on a failed check; writes what it read to ``spec["result"]``."""
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, events, metrics

    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    files = spec["files"]
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    out = {}
    t0 = time.perf_counter()
    ctx = port.runtime.init_cluster(advertise_host="127.0.0.1", num_workers=ELASTIC_WORKERS)
    try:
        elastic = sys.modules.get("ray_shuffling_data_loader_tpu_torch.runtime.elastic")
        if elastic is None or not elastic.running() or elastic.controller() is None:
            raise AssertionError("[elastic] the session did not start the elastic loop")
        ctl = elastic.controller()
        with open(spec["addr"] + ".tmp", "w") as f:
            f.write(ctx.cluster.address)
        os.replace(spec["addr"] + ".tmp", spec["addr"])
        deadline = time.monotonic() + 60
        while len(port.runtime.cluster_hosts()) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("[elastic] the second host did not join")
            time.sleep(0.05)
        hosts = ctx.cluster.registry.call("hosts")
        for info in hosts.values():  # each agent's pool up before the epochs
            ActorHandle(tuple(info["agent"])).call("submit", os.getpid, (), {})
        other = next(h for h in hosts if h != ctx.cluster.host_id)
        joined_session = other.rpartition(":")[2]
        out["up_s"] = time.perf_counter() - t0
        # The re-home timed on the controller itself.
        rehome, inner = {}, ctl._rehome_segments

        def timed_rehome(agent, store_handle=None):
            t = time.perf_counter()
            rehome["bytes"] = inner(agent, store_handle=store_handle)
            rehome["s"] = time.perf_counter() - t
            return rehome["bytes"]

        ctl._rehome_segments = timed_rehome
        # The head's residency a tenth of a second apart: the store's, and
        # the ledger's shm and spill, beside the epochs' states.
        timeline, stop = [], threading.Event()

        def sample():
            from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

            while not stop.wait(0.1):
                st, view = ctx.store.store_stats(), capacity.ledger()
                epochs = port_shuffle.live_status().get("epochs") or {}
                timeline.append((time.time(), st.total_bytes - st.spill_bytes, st.spill_bytes,
                                 capacity.shm_resident_bytes(view["totals"]),
                                 view["totals"]["spill"]["resident_bytes"],
                                 {e: s.get("state") for e, s in epochs.items()}))

        op = {}
        operator = threading.Thread(target=_elastic_operator, args=(spec, ctl, other, hosts, op), daemon=True)
        sampler = threading.Thread(target=sample, daemon=True)
        operator.start()
        sampler.start()
        try:
            reset_launches(ops)
            run = cluster_run(torch, port, files, "two hosts, elastic", model, init_state, tag="elastic",
                              cache_decoded=True)
            run["launches"] = read_launches(ops)
        finally:
            operator.join(timeout=120)
            stop.set()
            sampler.join(timeout=10)
        budget = ctx.store.capacity_bytes
        peak = max(t[1] for t in timeline) if timeline else None
        ledger_peak = max(t[3] for t in timeline) if timeline else None
        log(f"[elastic] budget {budget} B (the one-host peak {spec['reference']['store_peak_bytes']} B x "
            f"{ELASTIC_BUDGET_SHARE}); the head's shm peak {peak} B by the store, {ledger_peak} B by the ledger "
            f"(high watermark {ctl.evict_high} x budget = {ctl.evict_high * budget:.0f} B); run's store_peak_bytes "
            f"{run['store_peak_bytes']}; the operator: {op}")
        if timeline:  # every half second and at each change of the epochs' states
            t_first, shown, last = timeline[0][0], [], None
            for i, (ts, shm, spill, l_shm, l_spill, states) in enumerate(timeline):
                if i % 5 == 0 or states != last:
                    shown.append(f"{ts - t_first:.1f}s {shm / 1e6:.1f}/{l_shm / 1e6:.1f}/{spill / 1e6:.1f}/"
                                 f"{l_spill / 1e6:.1f} {''.join(f'{e}{(st or '?')[0]}' for e, st in states.items())}")
                last = states
            log("[elastic] the head's MB on shm (store/ledger) and spill (store/ledger), epochs' states: "
                + "; ".join(shown))
        if operator.is_alive() or "error" in op:
            raise AssertionError(f"[elastic] the operator: {op}")
        # (1) The run: the one host's tensors and losses, K1 once a step.
        ref = spec["reference"]
        if run["digests"] != ref["digests"] or run["losses"] != ref["losses"]:
            bad = [i for i, (a, b) in enumerate(zip(run["digests"], ref["digests"])) if a != b]
            raise AssertionError(f"[elastic] the run differs from the one host's: batches {bad[:5]}, losses "
                                 f"{run['losses'][:3]} against {ref['losses'][:3]}")
        n = run["launches"]
        if n["interaction_mma"] != run["steps"] or n["interaction"] != run["steps"] or run["steps"] != 30:
            raise AssertionError(f"[elastic] launches {n} in {run['steps']} steps: want 30 K1, all tensor-core")
        for v in run["verdicts"]:
            rows = [v[k] for k in ("rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed")]
            if v["ok"] is not True or v["mismatch"] or rows != [NUM_ROWS] * 4:
                raise AssertionError(f"[elastic] epoch {v['epoch']} verdict {v}")
        if [v["epoch"] for v in run["verdicts"]] != [0, 1]:
            raise AssertionError(f"[elastic] verdicts {run['verdicts']}")
        # (2) The loop's own eviction, in epoch 1 after epoch 0 left the fence.
        # Both rungs fire; what was dropped and read again was re-made
        # from its lineage (the run's tensors and verdicts say so).
        evicts = [r for r in events.load() if r.get("kind") in ("evict.demote", "evict.drop")]
        late = [r for r in evicts if r["ts"] >= op["epoch0_done_ts"]]
        if not late or not any(r["kind"] == "evict.drop" for r in evicts):
            raise AssertionError(f"[elastic] the loop's evictions after epoch 0 left the fence: {evicts}")
        unlost = [e for e in run["recovery"]["recovery_log"] or [] if e.get("error", "ObjectLostError")
                  != "ObjectLostError"]
        if unlost:
            raise AssertionError(f"[elastic] recoveries for other causes than a lost segment: {unlost}")
        # (3) The drain: handed over, re-homed with transition records, the
        # host retired, the drain's age back at 0.
        transitions = [r for r in capacity.load_records()
                       if r["op"] == "transition" and r["id"].startswith(f"{joined_session}-")]
        done = [r for r in events.load() if r.get("kind") == "scale.drain_done"]
        agent_str = ":".join(str(p) for p in hosts[other]["agent"])
        if (op["outcome"] != "drained" or not transitions or not rehome.get("bytes") or len(done) != 1
                or agent_str not in op["membership"]["retired"] or op["drain_age_after"] != 0.0):
            raise AssertionError(f"[elastic] drain: {op}; re-home {rehome}; {len(transitions)} transitions; "
                                 f"drain_done {done}")
        # (4) The scale-up, the totals and the gauges.
        ups = [r for r in events.load() if r.get("kind") == "scale.up"]
        summary = elastic.summary()
        snap = metrics.registry.snapshot()
        gauges = {k: snap.get(k) for k in ("elastic.shm_headroom_frac", "elastic.workers")}
        if (not ups or summary["scale_events"] < 1 or summary["drains"] != 1 or not summary["evicted_gb"] > 0
                or None in gauges.values()):
            raise AssertionError(f"[elastic] scale-ups {ups}; summary {summary}; gauges {gauges}")
        # (5) The ledger equals the store, by tier, at the run's end (the
        # owners' deletes of frees from the other host land within a
        # dispatch), and is 0 after the clean-up.
        t_wait = time.perf_counter()
        while True:
            st, totals = ctx.store.store_stats(), capacity.ledger()["totals"]
            ledger_tiers = (capacity.shm_resident_bytes(totals), totals["spill"]["resident_bytes"])
            store_tiers = (st.total_bytes - st.spill_bytes, st.spill_bytes)
            if ledger_tiers == store_tiers or time.perf_counter() - t_wait > 15:
                break
            time.sleep(0.1)
        if ledger_tiers != store_tiers:
            raise AssertionError(f"[elastic] at the run's end the ledger holds {ledger_tiers} B (shm, spill), the "
                                 f"store {store_tiers} B")
        ctx.store.cleanup()
        folded = capacity.ledger()
        after = (capacity.shm_resident_bytes(folded["totals"]), folded["totals"]["spill"]["resident_bytes"],
                 folded["live_segments"])
        if after != (0, 0, 0):
            raise AssertionError(f"[elastic] after the clean-up the ledger holds {after}")
        demoted = [r for r in evicts if r["kind"] == "evict.demote"]
        dropped = [r for r in evicts if r["kind"] == "evict.drop"]
        out.update(
            budget=budget, peak_store=peak, peak_ledger=ledger_peak, reference_peak=ref["store_peak_bytes"],
            demoted={"bytes": sum(r["nbytes"] for r in demoted), "segments": sum(r["segments"] for r in demoted),
                     "events": len(demoted)},
            dropped={"bytes": sum(r["nbytes"] for r in dropped), "segments": sum(r["segments"] for r in dropped),
                     "events": len(dropped)},
            first_evict_after_epoch0_s=min(r["ts"] for r in late) - op["epoch0_done_ts"],
            drain={"outcome": op["outcome"], "s": op["drain_s"], "waited_s": done[0]["waited_s"],
                   "rehome_bytes": rehome["bytes"], "rehome_s": rehome["s"],
                   "rehome_GB_s": rehome["bytes"] / rehome["s"] / 1e9, "transitions": len(transitions),
                   "evicted_before": op["evicted_before_drain"], "epoch1_at_drain": op["epoch1_at_drain"],
                   "joined_stopped_s": op["joined_stopped_s"]},
            scale_up={"events": len(ups), "forced": op.get("scale_up_forced"),
                      "reasons": [r.get("reason") for r in ups]},
            summary=summary, gauges=gauges, ledger_end=ledger_tiers,
            recovery=run["recovery"], schedules=run["schedules"], cache_decoded=run["cache_decoded"],
            run={k: run[k] for k in ("losses", "launches", "steps", "step_ms_median", "epoch_s", "epoch_shuffle_s",
                                     "stall_s", "stall_share")})
    finally:
        port.runtime.shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def phase_elastic(torch, filenames, cluster: dict, work: str) -> dict:
    """The ``[elastic]`` phase: :func:`elastic_head` and a host joined with
    ``python -m ...runtime.cluster join``, 4 workers each, on one machine,
    each with its own shared-memory and spill directories, one audit spool;
    both with metrics and the strict audit, the head with the elastic loop
    and a store budget of :data:`ELASTIC_BUDGET_SHARE` of the cluster
    phase's one-host peak. ``cluster``: the cluster phase's results (its
    one-host run is the reference; its two-host run, when there is one, is
    logged beside). No segment may be left in either host's directories."""
    t_phase = time.perf_counter()
    tag = f"rsdl-elastic-{os.getpid()}"
    single = cluster["single"]
    budget = int(single["store_peak_bytes"] * ELASTIC_BUDGET_SHARE)
    spec = {"files": filenames, "result": os.path.join(work, "result.json"), "addr": os.path.join(work, "address"),
            "joined_pid": os.path.join(work, "joined.pid"),
            "reference": {"digests": single["digests"], "losses": single["losses"],
                          "store_peak_bytes": single["store_peak_bytes"]}}
    base = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    base.update(RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_METRICS="1", RSDL_AUDIT="1", RSDL_AUDIT_STRICT="1",
                RSDL_AUDIT_DIR=os.path.join(work, "audit"))
    envs, dirs = {}, []
    for name in ("head", "joined"):
        envs[name] = {**base, "RSDL_SHM_DIR": f"/dev/shm/{tag}-{name}",
                      "RSDL_SPILL_DIR": os.path.join(work, f"spill-{name}")}
        dirs += [envs[name]["RSDL_SHM_DIR"], envs[name]["RSDL_SPILL_DIR"]]
    envs["head"].update(ELASTIC_ENV, RSDL_STORE_CAPACITY_BYTES=str(budget))
    procs = {}
    try:
        procs["head"] = start_head("elastic", spec, envs["head"])
        deadline = time.monotonic() + 240
        while not os.path.exists(spec["addr"]):
            if procs["head"].poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"[elastic] the head exited ({procs['head'].poll()}) or timed out before its "
                                     "address")
            time.sleep(0.05)
        with open(spec["addr"]) as f:
            address = f.read()
        with open(os.path.join(work, "joined.log"), "w") as out_f:
            procs["joined"] = subprocess.Popen(
                [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.runtime.cluster", "join", address,
                 "--num-workers", str(ELASTIC_WORKERS)], env=envs["joined"], cwd=ROOT, stdout=out_f,
                stderr=subprocess.STDOUT)
        with open(spec["joined_pid"] + ".tmp", "w") as f:
            f.write(str(procs["joined"].pid))
        os.replace(spec["joined_pid"] + ".tmp", spec["joined_pid"])
        codes = {name: proc.wait(timeout=300 if name == "head" else 120) for name, proc in procs.items()}
        # The drained host leaves on the operator's SIGINT: its session ends
        # in the join command's clean-up, which the interrupt then ends.
        if codes["head"] != 0 or codes["joined"] not in (0, -2, 130):
            raise AssertionError(f"[elastic] exit codes {codes}; the joined host's log: "
                                 f"{open(os.path.join(work, 'joined.log')).read()[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        left = {d: os.listdir(d) for d in dirs if os.path.isdir(d) and os.listdir(d)}
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    if left:
        raise AssertionError(f"[elastic] segments left after shutdown: { {d: v[:5] for d, v in left.items()} }")
    with open(spec["result"]) as f:
        res = json.load(f)
    run, two, smi = res["run"], cluster.get("cluster"), smi_name_and_limit()
    dr = res["drain"]
    log(f"[elastic] two hosts, the loop on: the one host's {run['steps']} losses and staged tensors bit for bit; K1 "
        f"{run['launches']['interaction_mma']} of {run['steps']} steps on the tensor-core route; both epochs ok "
        f"under strict audit; schedules {res['schedules']}, decode cache {res['cache_decoded']}; recoveries "
        f"{res['recovery']}; no segment left")
    log(f"[elastic] budget {res['budget']} B = {ELASTIC_BUDGET_SHARE} x the one-host peak {res['reference_peak']} B; "
        f"the head's shm peak {res['peak_store']} B (store), {res['peak_ledger']} B (ledger); demoted "
        f"{res['demoted']['bytes']} B in {res['demoted']['segments']} segments ({res['demoted']['events']} passes), "
        f"dropped {res['dropped']['bytes']} B in {res['dropped']['segments']} segments; the first eviction "
        f"{res['first_evict_after_epoch0_s']:.3f} s after epoch 0 left the fence ({smi})")
    log(f"[elastic] drain: {dr['outcome']} in {dr['s']:.3f} s (drain_done waited_s {dr['waited_s']}), re-homed "
        f"{dr['rehome_bytes']} B in {dr['rehome_s']:.3f} s = {dr['rehome_GB_s']:.3f} GB/s with {dr['transitions']} "
        f"transition records; evicted before it {dr['evicted_before']} B; epoch 1 at the drain {dr['epoch1_at_drain']}; "
        f"the host stopped {dr['joined_stopped_s']:.2f} s after its SIGINT ({smi})")
    log(f"[elastic] scale-ups {res['scale_up']}; summary {res['summary']}; gauges {res['gauges']}; the ledger "
        f"equal to the store at the run's end {res['ledger_end']} B (shm, spill), 0 after the clean-up")
    if two is not None:
        log(f"[elastic] step median {run['step_ms_median']!r} ms against the cluster phase's two hosts "
            f"{two['step_ms_median']!r} ms; shuffle s per epoch {run['epoch_shuffle_s']!r} against "
            f"{two['epoch_shuffle_s']!r}; stall share {run['stall_share']!r} against {two['stall_share']!r} ({smi})")
    res.pop("timeline", None)
    res["launches"] = run["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[elastic] phase {res['phase_s']:.1f} s (head {res['wall_s']:.1f} s, cluster up {res['up_s']:.1f} s; {smi})")
    return res


# The service phase: two tenants' DLRM trainers through one session of the
# multi-job service, each on its own thread of the head. Admission is made
# to act: a watermark of 0.0001 of a 4 GiB store budget (the decode cache
# alone holds about 2 % of it), a bound of 1 s. The card's host has about a
# terabyte of shm, of which the run's few hundred MB round to the watermark.
SERVICE_WORKERS = 8
SERVICE_ENV = {"RSDL_SERVICE": "auto", "RSDL_METRICS": "1", "RSDL_AUDIT": "1", "RSDL_AUDIT_STRICT": "1",
               "RSDL_SERVICE_ADMIT_FRAC": "0.0001", "RSDL_SERVICE_ADMIT_TIMEOUT_S": "1",
               "RSDL_STORE_CAPACITY_BYTES": str(4 << 30)}
# (name, weight, seed): dlrm-a trains the cluster phase's one-host run,
# dlrm-b its seed-1 run. Both start at once; dlrm-b's first window is held
# at its admission until dlrm-a's second is admitted (the registry then
# holds every file dlrm-a decoded), so that the two windows submit together.
SERVICE_TENANTS = (("dlrm-a", 2.0, 0), ("dlrm-b", 1.0, 1))
SERVICE_QUEUE = "rsdl-service-queue"  # one logical queue name for both tenants


def service_head(spec: dict) -> int:
    """The ``[service]`` phase's head, a process of its own started with
    :data:`SERVICE_ENV` (its first model is the cluster phase's initial
    state): the service-off solo run of dlrm-b's seed (the reference), then
    one session of :data:`SERVICE_WORKERS` workers where both tenants of
    :data:`SERVICE_TENANTS` register and each trains on its own thread
    inside its ``job_context`` with the decode cache on. dlrm-b's epoch 0
    waits, before its admission, for dlrm-a's epoch 1 to be admitted: its
    maps then find dlrm-a's decoded files in the registry, and its window
    and dlrm-a's second reach the fair share together. (Started only when
    the registry fills, dlrm-b would bring up its queue actor and stager
    after dlrm-a's reduces end, and admission holds each tenant's second
    window 1 s while the other's runs: no two windows would meet.) Counts K1 over both tenants, logs
    each release of the fair share with the queues it left, and polls the
    live status while they run. Writes what it read to ``spec["result"]``;
    the phase checks it."""
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch import shuffle as shuffle_mod
    from ray_shuffling_data_loader_tpu_torch.runtime import service
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit, metrics, trace

    t_head = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    files = spec["files"]
    models = [port.dlrm_for_data_spec() for _ in SERVICE_TENANTS]
    init_state = copy.deepcopy(models[0].state_dict())
    out = {"params": sum(p.numel() for p in models[0].parameters())}
    t0 = time.perf_counter()
    with environment({"RSDL_AUDIT_DIR": spec["spool_ref"]}, clear=("RSDL_SERVICE",)):
        trace.refresh_from_env()
        port.runtime.init(num_workers=SERVICE_WORKERS)
        try:
            start_pool(port)
            out["reference"] = cluster_run(torch, port, files, "solo seed 1", models[1], init_state, tag="service",
                                           seed=1, cache_decoded=True)
        finally:
            port.runtime.shutdown()
    out["reference_s"] = time.perf_counter() - t0
    trace.refresh_from_env()
    metrics.registry.clear()
    t0 = time.perf_counter()
    ctx = port.runtime.init(num_workers=SERVICE_WORKERS)
    try:
        out["pool_up_s"] = start_pool(port)
        sched = ctx.scheduler
        if not isinstance(sched, service.FairShareScheduler):
            raise AssertionError(f"[service] the session's scheduler is {type(sched).__name__}, not the fair share")
        # Each release of the fair share: its job, and the jobs with tasks
        # queued and in flight then.
        releases, pool, submit = [], ctx.pool, ctx.pool.submit

        def counted_submit(fn, *args, **kwargs):
            job = trace.current_context().get("job")
            if job is not None:
                releases.append((job, set(sched.queue_depths()), set(sched.inflight())))
            return submit(fn, *args, **kwargs)

        pool.submit = counted_submit
        jobs = {name: service.register_job(name=name, weight=w) for name, w, _ in SERVICE_TENANTS}
        runs, errors = {}, {}
        first, second = (jobs[name].job_id for name, _, _ in SERVICE_TENANTS)
        # dlrm-b's first window waits for dlrm-a's second: each admission,
        # its start and end from the tenants' first thread.
        admit, second_window, admissions = service.admit_epoch, threading.Event(), []

        def paced_admit(job, epoch, in_flight):
            t0 = time.perf_counter()
            if job.job_id == second and epoch == 0 and not second_window.wait(300):
                raise RuntimeError("dlrm-a's epoch 1 was never admitted")
            held = time.perf_counter() - t0
            waited = admit(job, epoch, in_flight)
            if job.job_id == first and epoch == 1:
                second_window.set()
            admissions.append({"job": job.job_id, "epoch": epoch, "at_s": t0 - t_run, "held_s": held,
                               "waited_s": waited})
            return waited

        def tenant(name: str, seed: int, model) -> None:
            try:
                with service.job_context(jobs[name]):
                    runs[name] = cluster_run(torch, port, files, name, model, init_state, tag="service", seed=seed,
                                             cache_decoded=True, queue_name=SERVICE_QUEUE)
            except BaseException as exc:
                errors[name] = f"{type(exc).__name__}: {exc}"
                second_window.set()  # a failed dlrm-a holds dlrm-b no longer

        service.admit_epoch = paced_admit
        reset_launches(ops)
        threads = [threading.Thread(target=tenant, args=(name, seed, model), name=f"tenant-{name}")
                   for (name, _, seed), model in zip(SERVICE_TENANTS, models)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        both_running = set()
        while any(t.is_alive() for t in threads):
            running = {j for j, st in (shuffle_mod.live_status().get("jobs") or {}).items() if st.get("running")}
            if len(running) > len(both_running):
                both_running = running
            time.sleep(0.05)
        for t in threads:
            t.join()
        out["run_s"] = time.perf_counter() - t_run
        out["launches"] = read_launches(ops)
        service.admit_epoch = admit
        out["admissions"] = admissions
        if errors:
            raise AssertionError(f"[service] tenants failed: {errors}")
        ids = {name: job.job_id for name, job in jobs.items()}
        out["ids"], out["both_running"] = ids, sorted(both_running)
        out["queues"] = {name: run["queue"] for name, run in runs.items()}
        out["tracked"] = sorted((shuffle_mod.live_status().get("jobs") or {}))
        out["snapshot"] = [r["job_id"] for r in service.jobs_snapshot()]
        out["verdicts"] = {name: audit.reconcile(range(2), job=jid) for name, jid in ids.items()}
        out["claims_live"] = len(service.claimed_cache_ids())
        for job in jobs.values():
            service.end_job(job)
        out["claims_after"] = sorted(service.claimed_cache_ids())
        out["live_after"] = service.live_jobs_count()
        snap = metrics.registry.snapshot()
        out["metrics"] = {k: v for k, v in snap.items() if k.startswith("service.")}
        # Releases while the other tenant had tasks queued (the share by
        # weight), and while it had tasks queued or in flight.
        queued = [job for job, q, _ in releases if q - {job}]
        active = [job for job, q, f in releases if (q | f) - {job}]
        out["releases"] = {"total": {j: sum(1 for r, _, _ in releases if r == j) for j in ids.values()},
                           "both_backlogged": {j: queued.count(j) for j in ids.values()},
                           "both_active": {j: active.count(j) for j in ids.values()}}
        out["runs"] = runs
    finally:
        port.runtime.shutdown()
    out["session_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_head
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def phase_service(torch, filenames, cluster: dict, work: str) -> dict:
    """The ``[service]`` phase: :func:`service_head` with its own shared
    memory and spill directories and one audit spool (strict), then the
    checks: each tenant's staged tensors and losses bit for bit its solo
    reference (dlrm-a: the cluster phase's one-host run; dlrm-b: the
    service-off seed-1 run), K1 once a step of both on its tensor-core
    route, per-job verdicts ``ok``, two queue actors scoped to their jobs,
    dlrm-b's epoch 0 decoded from no row group with cache hits of its own,
    the fair share throttled, admission acted, both jobs tracked and in
    the snapshot, both shuffles running at once with releases of each job
    while the other had tasks queued or in flight, and at the end no job
    live, no claim, no segment left."""
    t_phase = time.perf_counter()
    tag = f"rsdl-service-{os.getpid()}"
    single, smi = cluster["single"], smi_name_and_limit()
    spec = {"files": filenames, "result": os.path.join(work, "result.json"), "spool_ref": os.path.join(work, "ref")}
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env.update(SERVICE_ENV, RSDL_AUDIT_DIR=os.path.join(work, "audit"), RSDL_SHM_DIR=f"/dev/shm/{tag}",
               RSDL_SPILL_DIR=os.path.join(work, "spill"))
    dirs = [env["RSDL_SHM_DIR"], env["RSDL_SPILL_DIR"]]
    proc = start_head("service", spec, env)
    try:
        code = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        left = {d: os.listdir(d) for d in dirs if os.path.isdir(d) and os.listdir(d)}
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    if code != 0:
        raise AssertionError(f"[service] the head exited {code}")
    if left:
        raise AssertionError(f"[service] segments left after shutdown: { {d: v[:5] for d, v in left.items()} }")
    with open(spec["result"]) as f:
        res = json.load(f)
    runs, ids, ref = res["runs"], res["ids"], res["reference"]
    a, b = (runs[name] for name, _, _ in SERVICE_TENANTS)
    if (a["digests"], a["losses"]) != (single["digests"], single["losses"]):
        raise AssertionError("[service] dlrm-a staged or trained other than the cluster phase's one-host run")
    if (b["digests"], b["losses"]) != (ref["digests"], ref["losses"]):
        raise AssertionError("[service] dlrm-b staged or trained other than its service-off solo run")
    if ref["digests"] == single["digests"]:
        raise AssertionError("[service] the seed-1 reference staged the seed-0 stream")
    n, steps = res["launches"], a["steps"] + b["steps"]
    if (n["interaction"] != steps or n["interaction_mma"] != steps or steps != 2 * single["steps"]
            or any(v for k, v in n.items() if not k.startswith("interaction"))):
        raise AssertionError(f"[service] launches {n} in {steps} steps of both tenants, want one K1 per step, all on "
                             "the tensor-core route")
    for name, verdicts in res["verdicts"].items():
        if [v["epoch"] for v in verdicts] != [0, 1] or not all(v["ok"] is True and v["job"] == ids[name]
                                                               and v["rows_consumed"] == NUM_ROWS for v in verdicts):
            raise AssertionError(f"[service] {name}: verdicts {verdicts}")
    queues = res["queues"]
    if len(set(queues.values())) != 2 or any(queues[n_] != f"{SERVICE_QUEUE}--{ids[n_]}" for n_ in ids):
        raise AssertionError(f"[service] queue actors {queues} for jobs {ids}")
    rowgroups_b0 = (b["decode_rowgroups"] or {}).get("0", 0)
    hits_b = res["metrics"].get(f"service.cache_hits{{job={ids['dlrm-b']}}}", 0)
    if rowgroups_b0 != 0 or not hits_b > 0:
        raise AssertionError(f"[service] dlrm-b's epoch 0 decoded {rowgroups_b0} row groups, cache hits {hits_b}")
    m = res["metrics"]
    throttled = m.get("service.tasks_throttled", 0)
    timeouts = sum(v for k, v in m.items() if k.startswith("service.admission_timeouts"))
    waits = sum(v for k, v in m.items() if k.startswith("service.admission_wait_seconds") and k.endswith("_count"))
    wait_s = sum(v for k, v in m.items() if k.startswith("service.admission_wait_seconds") and k.endswith("_sum"))
    if not throttled > 0:
        raise AssertionError(f"[service] the fair share never throttled: {m}")
    if not (timeouts >= 1 or waits >= 1):
        raise AssertionError(f"[service] admission never acted: {m}")
    if not (set(ids.values()) <= set(res["tracked"]) and set(ids.values()) <= set(res["snapshot"])):
        raise AssertionError(f"[service] tracked {res['tracked']}, snapshot {res['snapshot']}; jobs {ids}")
    rel = res["releases"]
    if set(res["both_running"]) != set(ids.values()) or not all(rel["both_active"].get(j, 0) > 0 for j in ids.values()):
        raise AssertionError(f"[service] the tenants never shared the pool: shuffles running at once "
                             f"{res['both_running']}, releases while the other had tasks queued or in flight "
                             f"{rel['both_active']}; admissions {res['admissions']}")
    if res["claims_after"] or res["live_after"] != 0:
        raise AssertionError(f"[service] after both ended: claims {res['claims_after']}, live jobs {res['live_after']}")
    log(f"[service] two tenants in one session ({res['params']} parameters each, 8 workers): dlrm-a (weight 2) "
        f"trained the cluster phase's one-host {a['steps']} losses and staged tensors bit for bit, dlrm-b (weight 1) "
        f"its service-off seed-1 run's; K1 {n['interaction_mma']} of {steps} steps on the tensor-core route; every "
        f"epoch ok per job under strict audit; queues {sorted(queues.values())}; dlrm-b's epoch 0 decoded "
        f"{rowgroups_b0} row groups ({hits_b:.0f} cache hits; schedules {b['schedules']}); {res['claims_live']} "
        f"claimed segments while live, none after; no job live, no segment left")
    log(f"[service] fair share: {throttled:.0f} throttled pumps; releases per job {rel['total']}, while the other "
        f"had tasks queued {rel['both_backlogged']} (weights 2:1), queued or in flight {rel['both_active']}; "
        f"admission waited {waits:.0f} times, {wait_s!r} s in all, {timeouts:.0f} timeouts; shuffles running at once "
        f"{res['both_running']} ({smi})")
    log(f"[service] admissions (s since the tenants started; dlrm-b's epoch 0 held for dlrm-a's epoch 1): "
        + "; ".join(f"{a['job']} epoch {a['epoch']} at {a['at_s']:.3f}, held {a['held_s']:.3f}, waited "
                    f"{a['waited_s']:.3f}" for a in res["admissions"]))
    for name, run in (("dlrm-a", a), ("dlrm-b", b)):
        log(f"[service] {name}: step median {run['step_ms_median']!r} ms, stall share {run['stall_share']!r}, shuffle "
            f"s per epoch {run['epoch_shuffle_s']!r}, schedules {run['schedules']}; the cluster phase's one host: "
            f"{single['step_ms_median']!r} ms, {single['stall_share']!r}, {single['epoch_shuffle_s']!r} ({smi})")
    for run in (a, b, ref):
        run.pop("digests", None)
    res["launches_service"] = n["interaction_mma"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[service] phase {res['phase_s']:.1f} s (head {res['wall_s']:.1f} s: the reference {res['reference_s']:.1f} "
        f"s, the two tenants {res['run_s']:.1f} s; {smi})")
    return res


def read_plane_line(label: str, stats: dict, schedules) -> dict:
    """Log and return what a run's read plane did: the plan and its terms,
    the projection, each epoch's schedule and shuffle seconds, the row
    groups and bytes decoded from Parquet, the pruned bytes and the shared
    cache's hits."""
    out = {
        "plan": stats.get("plan"),
        "plan_terms": {k: v["value"] for k, v in (stats.get("plan_terms") or {}).items()},
        "selective_reads": stats.get("selective_reads"),
        "columns": stats.get("columns"),
        "schedules": list(schedules),
        "epoch_shuffle_s": stats.get("epoch_shuffle_s"),
        "decode_rowgroups": stats.get("decode_rowgroups"),
        "decode_bytes": stats.get("decode_bytes"),
        "decode_bytes_pruned": stats.get("decode_bytes_pruned"),
        "shared_cache_hits": stats.get("shared_cache_hits"),
        "cache_decoded": stats.get("cache_decoded"),
    }
    def short(cols):
        return cols if cols is None or len(cols) <= 10 else f"{len(cols)} columns"

    terms = {k: short(v) if k == "columns" else v for k, v in out["plan_terms"].items()}
    log(f"[plan {label}] plan {out['plan']} (terms {terms}); selective: {out['selective_reads']}; "
        f"columns {short(out['columns'])}; cache_decoded {out['cache_decoded']}")
    log(f"[plan {label}] schedules {out['schedules']}, shuffle {out['epoch_shuffle_s']!r} s per epoch; decoded "
        f"{out['decode_rowgroups']} row groups, {out['decode_bytes']} B; pruned {out['decode_bytes_pruned']} B; "
        f"shared-cache hits {out['shared_cache_hits']}")
    return out


def plan_dlrm_run(torch, port, filenames, model, init_state, label: str, cache_decoded, with_key: bool) -> dict:
    """Two epochs of the DLRM from ``init_state`` (a fresh Adam 1e-3) over
    the plan phase's dataset: per batch a digest of the staged tensors
    (``key`` excluded) and the loss; K1's launches counted from 0."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch.ops as ops

    batch_size = 65536
    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    model.load_state_dict(init_state)
    step = port.make_train_step(model, port.make_optimizer(model))
    ds = port.DeviceShufflingDataset(
        filenames, num_epochs=2, num_trainers=1, batch_size=batch_size, rank=0,
        feature_columns=features + ([port.KEY_COLUMN] if with_key else []), label_column=port.LABEL_COLUMN,
        num_reducers=8, seed=0, device="cuda", cache_decoded=cache_decoded,
    )
    reset_launches(ops)
    digests, losses = [], []
    for epoch in range(2):
        ds.set_epoch(epoch)
        keys, rows = [], 0
        for feats, labels in ds:
            if with_key:
                keys.append(feats.pop(port.KEY_COLUMN))
            rows += labels.numel()
            digests.append(batch_digest(torch, [*feats.values(), labels]))
            losses.append(step(feats, labels)["loss"].item())
        want = (NUM_ROWS // batch_size) * batch_size
        if rows != want:
            raise AssertionError(f"[plan {label}] epoch {epoch}: {rows} rows, want {want}")
        if with_key:
            got = torch.cat(keys).cpu().numpy()
            if np.unique(got).size != want or got.min() < 0 or got.max() >= NUM_ROWS:
                raise AssertionError(f"[plan {label}] epoch {epoch}: {np.unique(got).size} distinct keys of {want}")
    launches = read_launches(ops)
    ds.join()
    steps = len(losses)
    if launches["interaction"] != steps or launches["interaction_mma"] != steps:
        raise AssertionError(f"[plan {label}] launches {launches} in {steps} steps, want one K1 per step, all on "
                             f"the tensor-core route")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[plan {label}] non-finite loss: {losses}")
    stats = ds.dataset.shuffle_stats
    report = read_plane_line(label, stats, [s for _, s in ds.dataset.schedule_log])
    check_host_calls(f"plan {label}", {"native_calls": stats["native_calls"], "plain_calls": stats["plain_calls"]},
                     group_by="selective" not in report["schedules"])
    log(f"[plan {label}] {steps} steps, losses {losses[0]!r} -> {losses[-1]!r}; K1 launches {launches['interaction']}")
    return {"digests": torch.stack(digests).cpu(), "losses": losses, "launches": launches, "report": report}


class _KeyColumns:
    """A draining consumer for delivery-only runs: every ``key`` per epoch
    and the column set of every segment."""

    def __init__(self, port):
        self.port = port
        self.keys, self.column_sets = {}, set()

    def consume(self, rank, epoch, batches):
        store = self.port.runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            self.column_sets.add(tuple(sorted(cb.columns)))
            self.keys.setdefault(epoch, []).append(cb["key"].copy())
        store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def plan_delivery(port, filenames, **kwargs) -> tuple:
    """One 2-epoch ``shuffle()`` into :class:`_KeyColumns` (8 reducers, one
    rank, narrowed); returns the consumer, the stats and the schedules."""
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

    consumer, stats, log_ = _KeyColumns(port), {}, []
    port_shuffle.shuffle(filenames, consumer, 2, 8, 1, seed=0, narrow_to_32=True, schedule_log=log_, stats=stats,
                         **kwargs)
    return consumer, stats, [s for _, s in log_]


def phase_plan(torch, data_dir: str) -> dict:
    """The read plane on the Quick-start shape written with 20 row groups a
    file: the planned DLRM runs against the hand-set ones and the
    layout's projection against the full decode (staged tensors and
    losses bit-identical; the DLRM step under deterministic algorithms,
    whose embedding backward is otherwise not); an explicit narrow
    projection, delivery only; and the shared decode cache over two runs."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

    out: dict = {}
    t_phase = time.perf_counter()
    port.runtime.init()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        t0 = time.perf_counter()
        filenames, nbytes = port.generate_data(NUM_ROWS, 10, PLAN_ROW_GROUPS, 0.0, data_dir, seed=0)
        log(f"[plan] generated {NUM_ROWS} rows ({nbytes} B) in {len(filenames)} files of {PLAN_ROW_GROUPS} row "
            f"groups in {time.perf_counter() - t0:.2f} s")
        model = port.dlrm_for_data_spec()
        init_state = copy.deepcopy(model.state_dict())
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = {}
        for label, env, cache_decoded, with_key in PLAN_DLRM_RUNS:
            with environment(env, clear=PLAN_KNOBS):
                runs[label] = plan_dlrm_run(torch, port, filenames, model, init_state, label, cache_decoded, with_key)
        torch.use_deterministic_algorithms(deterministic)
        for a, b in PLAN_PAIRS:
            ra, rb = runs[a], runs[b]
            if not torch.equal(ra["digests"], rb["digests"]):
                raise AssertionError(f"[plan] {a}: staged tensors differ from {b}'s")
            diff = max(abs(x - y) for x, y in zip(ra["losses"], rb["losses"]))
            if ra["losses"] != rb["losses"]:
                raise AssertionError(f"[plan] {a}: losses differ from {b}'s by up to {diff!r}")
            log(f"[plan] {a} = {b}: {len(ra['losses'])} batches' staged tensors and losses bit-identical")
        reports = {label: run["report"] for label, run in runs.items()}
        want_cols = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN] + [port.KEY_COLUMN, port.LABEL_COLUMN]
        for label in ("planned_cache", "planned_nocache"):
            r = reports[label]
            if r["plan"] != "block:1" or r["plan_terms"].get("plan") != ["block", 1] or r["columns"] != want_cols:
                raise AssertionError(f"[plan] {label}: {r}")
        if "selective" in reports["planned_cache"]["schedules"] or reports["planned_cache"]["plan_terms"]["selective"]:
            raise AssertionError(f"[plan] planned_cache engaged selective: {reports['planned_cache']}")
        if reports["planned_nocache"]["schedules"] != ["selective"] * 2:
            raise AssertionError(f"[plan] planned_nocache: {reports['planned_nocache']}")
        if not reports["pushdown_on"]["decode_bytes_pruned"] or reports["pushdown_off"]["decode_bytes_pruned"]:
            raise AssertionError(f"[plan] pruned bytes: on {reports['pushdown_on']['decode_bytes_pruned']}, "
                                 f"off {reports['pushdown_off']['decode_bytes_pruned']}")
        out["dlrm"] = {label: {"losses": run["losses"], "launches": run["launches"], **run["report"]}
                       for label, run in runs.items()}
        out["launches"] = {k: sum(run["launches"][k] for run in runs.values()) for k in runs["pushdown_on"]["launches"]}
        del model, init_state, runs

        # An explicit narrow projection, delivery only, against the full decode.
        delivery = {}
        for label, kwargs in (("narrow_projection", {"columns": NARROW_PROJECTION}), ("full_decode", {})):
            consumer, stats, schedules = plan_delivery(port, filenames, **kwargs)
            for epoch in range(2):
                keys = np.concatenate(consumer.keys[epoch])
                if keys.size != NUM_ROWS or not np.array_equal(np.sort(keys), np.arange(NUM_ROWS)):
                    raise AssertionError(f"[plan {label}] epoch {epoch}: {keys.size} keys, not each key once")
            est = port_shuffle._est_decoded_bytes(filenames, True, kwargs.get("columns"))
            delivery[label] = {**read_plane_line(label, stats, schedules), "est_decoded_bytes": est,
                               "column_sets": sorted(consumer.column_sets)}
            log(f"[plan {label}] estimate {est!r} B; schedules auto chose {schedules}; every key once an epoch")
        if delivery["narrow_projection"]["column_sets"] != [tuple(sorted(NARROW_PROJECTION))]:
            raise AssertionError(f"[plan] narrow projection delivered {delivery['narrow_projection']['column_sets']}")
        out["delivery"] = delivery

        # The shared decode cache over two runs back to back.
        shared = {}
        with environment({"RSDL_DECODE_CACHE_SHARED": "on"}, clear=PLAN_KNOBS):
            try:
                for label in ("shared_first", "shared_second"):
                    consumer, stats, schedules = plan_delivery(port, filenames, cache_decoded=True)
                    shared[label] = {**read_plane_line(label, stats, schedules),
                                     "keys": [np.concatenate(consumer.keys[e]) for e in range(2)]}
            finally:
                port_shuffle.shared_decode_cache_clear(free=True)
        first, second = shared["shared_first"], shared["shared_second"]
        if second["decode_rowgroups"].get(0) or not first["decode_rowgroups"].get(0):
            raise AssertionError(f"[plan] row groups decoded in epoch 0: first {first['decode_rowgroups']}, "
                                 f"second {second['decode_rowgroups']}")
        if not all(np.array_equal(a, b) for a, b in zip(first.pop("keys"), second.pop("keys"))):
            raise AssertionError("[plan] the shared-cache runs delivered different streams")
        log(f"[plan] shared cache: the second run decoded no Parquet in epoch 0 and delivered the first's stream; "
            f"epoch 0 shuffle {first['epoch_shuffle_s'][0]!r} s, then {second['epoch_shuffle_s'][0]!r} s")
        out["shared"] = shared
    finally:
        torch.use_deterministic_algorithms(deterministic)
        port.runtime.shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[plan] phase {out['wall_s']:.1f} s; K1 launches over its DLRM runs {out['launches']}")
    return out


# (label, multirank arguments): the four runs of the ranks phase.
RANK_RUNS = (
    ("ddp_mean_2", ["--num-trainers", "2", "--backend", "gloo", "--step", "ddp", "--epochs", "1"]),
    ("adasum_bf16_3", ["--num-trainers", "3", "--backend", "gloo", "--step", "psum", "--grad-reduce", "adasum",
                       "--grad-dtype", "bfloat16", "--epochs", "1"]),
    ("nccl_1", ["--num-trainers", "1", "--backend", "nccl", "--step", "psum", "--grad-dtype", "bfloat16", "--epochs", "1",
                "--max-steps", "3"]),
    ("dp2_mp2", ["--num-trainers", "2", "--model-parallelism", "2", "--backend", "gloo", "--step", "ddp",
                 "--epochs", "1"]),
)
# The tables the rule shards at full width over a model group of 2.
SHARDED_AT_MP2 = ["embeddings.embeddings_name12.weight", "embeddings.embeddings_name14.weight"]
# dp2_mp2 against ddp_mean_2 on the same batches: the forward is exact, so
# only the order of the sharded tables' gradient sums may differ.
MP_LOSS_TOL = 1e-4
STARTUP_MARKS = ("imports", "runtime", "groups", "model", "optimizer", "step_made", "pool_ready", "first_batch",
                 "last_step", "reported", "teardown")


# The ranks phase's runs in one round, side by side, each in a process of
# its own (a process holds one session): a rank's start-up, not its steps,
# is most of a run. Each run's session has RANK_WORKERS pool workers.
RANK_ROUNDS = (("ddp_mean_2", "adasum_bf16_3", "nccl_1", "dp2_mp2"),)
RANK_WORKERS = 4


def ranks_run(spec: dict) -> int:
    """One run of the ranks phase in a process of its own:
    ``multirank.run`` with ``spec["argv"]`` over ``spec["files"]``, its
    result and wall seconds written to ``spec["result"]``."""
    from ray_shuffling_data_loader_tpu_torch import multirank

    t0 = time.perf_counter()
    out = multirank.run(multirank.parse_args(spec["argv"]), filenames=spec["files"])
    out["wall_s"] = time.perf_counter() - t0
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def phase_ranks(filenames, smi: str, work: str) -> dict:
    """The multi-rank runs, in :data:`RANK_ROUNDS`; each rank's numbers on
    lines of their own. Side by side, two runs share the card and the host's
    cores: their step medians do not compare with runs made one at a time."""
    t_phase = time.perf_counter()
    argvs = dict(RANK_RUNS)
    outs = {}
    for round_labels in RANK_ROUNDS:
        t_round = time.perf_counter()
        procs = {}
        try:
            for label in round_labels:
                spec = {"files": filenames, "result": os.path.join(work, f"{label}.json"), "argv": [
                    *argvs[label], "--batch-size", "65536", "--num-rows", str(NUM_ROWS), "--num-reducers", "8",
                    "--seed", "0", "--timeout", "300", "--num-workers", str(RANK_WORKERS)]}
                spec_path = os.path.join(work, f"{label}-spec.json")
                with open(spec_path, "w") as f:
                    json.dump(spec, f)
                env = {k: v for k, v in os.environ.items() if k != "RSDL_RUNTIME_DIR"}
                procs[label] = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--ranks-run",
                                                 spec_path], env=env, cwd=ROOT)
            codes = {label: proc.wait(timeout=420) for label, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(codes.values()):
            raise AssertionError(f"[ranks] round {round_labels}: exit codes {codes}")
        for label in round_labels:
            with open(os.path.join(work, f"{label}.json")) as f:
                outs[label] = json.load(f)
        log(f"[ranks] round {' + '.join(round_labels)} side by side: {time.perf_counter() - t_round:.1f} s ({smi})")
    runs = {}
    for label, _ in RANK_RUNS:
        out, wall = outs[label], outs[label]["wall_s"]
        if out["returncode"] != 0:
            raise AssertionError(f"[ranks] {label}: exit code {out['returncode']}: {out['problems']}")
        want_sharded = SHARDED_AT_MP2 if out["spec"]["model_parallelism"] == 2 else []
        for res in out["ranks"]:
            n = res["launches"]
            if (n["interaction"]["launches"] != res["steps"] or n["interaction"]["mma_launches"] != res["steps"]
                    or any(n[k]["launches"] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))):
                raise AssertionError(f"[ranks] {label} rank {res['rank']}: launches {n} in {res['steps']} steps, "
                                     "want one interaction per step, all on the tensor-core route, and no flash")
            if res["sharded"] != want_sharded:
                raise AssertionError(f"[ranks] {label} rank {res['rank']}: sharded {res['sharded']}, "
                                     f"want {want_sharded}")
            e = res["epochs"]
            lead = "rows_read" in e[0]
            reading = (f"stall share {res['stall_share']!r}; first batch {[x['first_batch_s'] for x in e]!r} s; "
                       f"get_batch round trip {min(x['get_batch_min_s'] for x in e)!r} s (min; median "
                       f"{statistics.median(x['get_batch_median_s'] for x in e)!r} s); "
                       if lead else "batches from its lead; ")
            log(f"[ranks] {label} rank {res['rank']} (data {res['data_index']}, model {res['model_index']}; "
                f"{res['device']}): {res['steps']} steps "
                f"({', '.join(f"{x['steps']} ({x['idle']} idle) + {x['drained']} drained" for x in e)} per epoch), "
                f"step median {res['step_ms_median']!r} ms (first {res['step_ms_first']!r} ms); data-group "
                f"collective (timed alone) {res['comm_ms']!r} ms for {res['comm_bytes']} B per step; lookup sum "
                f"over the model group (timed alone) {res['lookup_sum_ms']!r} ms for {res['lookup_sum_bytes']!r} B "
                f"per step; {reading}worker pool ready {res['pool_ready_s']!r} s; shm {res['shm_dir']} "
                f"{res['shm_free_bytes']} B free; store peak {res['store_peak_bytes']!r} B; parameters "
                f"{res['param_count']} ({res['param_bytes']} B; sharded {res['sharded']}); peak device memory "
                f"{res['peak_device_bytes']} B; launches {n['interaction']}; losses {res['losses'][0]!r} -> "
                f"{res['losses'][-1]!r}")
            marks = res["startup_s"]
            log(f"[ranks] {label} rank {res['rank']} start-up and shutdown, s since spawn: "
                + ", ".join(f"{k} {marks[k]:.3f}" for k in STARTUP_MARKS if k in marks))
        if label == "dp2_mp2":
            ref = runs["ddp_mean_2"]["ranks"][0]
            first = ref["losses"][: ref["epochs"][0]["steps"]]
            got = out["ranks"][0]["losses"]
            worst = max(abs(a - b) for a, b in zip(got, first)) if len(got) == len(first) else math.inf
            if not worst <= MP_LOSS_TOL:
                raise AssertionError(f"[ranks] dp2_mp2: losses {got} against ddp_mean_2's epoch 0 {first}: "
                                     f"max difference {worst!r} > {MP_LOSS_TOL}")
            log(f"[ranks] dp2_mp2: {len(got)} global losses within {MP_LOSS_TOL} of ddp_mean_2's epoch 0 on the same "
                f"batches: max |difference| {worst!r}")
        log(f"[ranks] {label}: {len(out['ranks'])} ranks, exactly once in every epoch, finite losses, "
            f"replicated parameters bit-identical on every rank, shards across their data group, gathered state "
            f"({out['ranks'][0]['params_sha256'][:16]}) on every rank, {wall:.1f} s ({smi})")
        runs[label] = {"wall_s": wall, "ranks": out["ranks"]}
    log(f"[ranks] done in {time.perf_counter() - t_phase:.1f} s")
    return runs


# bench.py's quick shape (the JAX package's own configuration of the
# resident path): rows, files, row groups per file, batch, epochs.
RESIDENT_ROWS, RESIDENT_FILES, RESIDENT_ROW_GROUPS = 11_904_761, 16, 2
RESIDENT_BATCH, RESIDENT_EPOCHS = 250_000, 2
# The fused epoch against the eager loop: the same kernels in the same
# order on the same data; a replay may differ only by the order of a
# reduction inside one of them.
FUSED_TOL = 1e-5


def cuda_ms(torch, fn):
    """``(result, device ms)`` of ``fn()``, timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def trial_line(label: str, trial) -> str:
    row = trial.row()
    return (f"[stats] {label}: row throughput {row['row_throughput']!r} rows/s, duration {row['duration']!r} s, "
            f"stall {row['total_stall_s']!r} s ({row['stall_pct']!r} %), epochs {row['num_epochs']}, "
            f"bytes staged {row['total_bytes_staged']}")


def phase_resident(torch, data_dir: str, smi: str) -> dict:
    """The device-resident loader and its fused epoch (docstring, phase 5)."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch import resident

    n, b = RESIDENT_ROWS, RESIDENT_BATCH
    full = n // b
    key = port.KEY_COLUMN
    feature_columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN] + [key]
    out = {}
    port.runtime.init()
    try:
        t0 = time.perf_counter()
        filenames, nbytes = port.generate_data(n, RESIDENT_FILES, RESIDENT_ROW_GROUPS, 0.0, data_dir, seed=0)
        log(f"[resident] generated {n} rows ({nbytes} B) in {len(filenames)} files in "
            f"{time.perf_counter() - t0:.2f} s")
        budget, per_device = resident.device_memory_budget(device="cuda")
        need = resident.packed_nbytes(n, len(feature_columns))
        fits = port.fits_device(filenames, len(feature_columns), device="cuda")
        log(f"[resident] fits_device: {fits} ({need} B packed against a budget of {budget} B, per device "
            f"{per_device})")
        if not fits:
            raise AssertionError("[resident] fits_device said no at bench.py's quick shape")
        collector = port.runtime.spawn_actor(port.TrialStatsCollector, RESIDENT_EPOCHS, 1, 1, n, b, 1,
                                             name="resident-stats")
        datasets = {}
        for label, materialize, sc in (("materialized", None, collector), ("gather", False, None)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ds = port.DeviceResidentShufflingDataset(
                filenames, RESIDENT_EPOCHS, b, feature_columns, port.LABEL_COLUMN, seed=0, device="cuda",
                materialize_epoch=materialize, stats_collector=sc,
            )
            staged_s = time.perf_counter() - t0
            pieces = math.ceil(n / resident.DEFAULT_PIECE_ROWS)
            staging_peak = torch.cuda.max_memory_allocated() - before
            log(f"[resident] {label}: staged {ds.stats.bytes_staged} B in {pieces} pieces in {staged_s!r} s "
                f"(first batch {ds.stats.first_batch_s!r} s); peak device memory of the staging "
                f"{staging_peak} B (above the {before} B allocated before); schedule materialized={ds._materialize}")
            out[f"staging_{label}"] = {"s": staged_s, "bytes": ds.stats.bytes_staged, "pieces": pieces,
                                       "peak_device_bytes": staging_peak}
            datasets[label] = ds
        if not datasets["materialized"]._materialize:
            raise AssertionError("[resident] the budget chose the gather schedule at 1 GB on an 80 GB card")

        # Epoch 0 per batch: the delivered keys are the JAX package's
        # permutation, in both schedules.
        want = port.epoch_permutation(0, 0, n, device="cpu")[: full * b]
        # The first call of a run, then two more.
        perm_ms = [cuda_ms(torch, lambda: port.epoch_permutation(0, 1, n, device="cuda"))[1] for _ in range(3)]
        for label, ds in datasets.items():
            ds.set_epoch(0)
            key_batches, epoch_ms = cuda_ms(torch, lambda: [f[key].clone() for f, _ in ds])
            batches = len(key_batches)
            if batches != full or not torch.equal(torch.cat(key_batches).cpu().to(torch.int64), want):
                raise AssertionError(f"[resident] {label} epoch 0: {batches} batches; keys differ from "
                                     "epoch_permutation(0, 0, n)")
            log(f"[resident] {label} epoch 0: {batches} batches, keys == epoch_permutation(0, 0, {n})"
                f"[:{full * b}], exactly once; {epoch_ms / batches!r} ms per batch (delivery only)")
        if np.unique(want.numpy()).size != want.numel():
            raise AssertionError("[resident] the permutation repeats a row")
        log(f"[resident] schedules equal; epoch_permutation of {n} rows on the card: {perm_ms!r} ms (three calls)")
        out["perm_ms"] = perm_ms

        # Epoch 1: the eager loop, then the fused epoch on each schedule,
        # from the same weights and a fresh optimizer each time.
        model = port.dlrm_for_data_spec()
        initial = [p.detach().clone() for p in model.parameters()]

        def fresh_step():
            with torch.no_grad():
                for p, v in zip(model.parameters(), initial):
                    p.copy_(v)
            return port.make_train_step(model, port.make_optimizer(model, capturable=True))

        step = fresh_step()
        ds = datasets["materialized"]
        ds.set_epoch(1)
        reset_launches(ops)

        def eager():
            losses = []
            for f, labels in ds:
                f.pop(key)
                losses.append(step(f, labels)["loss"])
            return torch.stack(losses)

        eager_losses, eager_ms = cuda_ms(torch, eager)
        eager_launches = read_launches(ops)
        if eager_launches["interaction_mma"] != full or eager_launches["interaction"] != full:
            raise AssertionError(f"[resident] eager: launches {eager_launches}, want {full} on the tensor-core route")
        out["eager"] = {"ms_per_batch": eager_ms / full, "rows_per_s": b * full / (eager_ms / 1e3),
                        "losses": eager_losses.tolist()}
        log(f"[resident] eager epoch 1: {full} steps, {eager_ms / full!r} ms per batch, "
            f"{out['eager']['rows_per_s']!r} rows/s; losses {eager_losses[0].item()!r} -> "
            f"{eager_losses[-1].item()!r}")
        for label, ds in datasets.items():
            step = fresh_step()
            reset_launches(ops)
            t0 = time.perf_counter()
            run_epoch = port.make_fused_epoch(ds, step)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            captured = read_launches(ops)
            per_step = captured["interaction_mma"] / (resident.FUSED_WARMUP_STEPS + 1)
            if per_step != 1 or captured["interaction"] != captured["interaction_mma"]:
                raise AssertionError(f"[resident] {label}: {captured} in {resident.FUSED_WARMUP_STEPS} warm-up "
                                     "steps and the capture, want one K1 each on the tensor-core route")
            reset_launches(ops)
            losses, fused_ms = cuda_ms(torch, lambda: run_epoch(1))
            replayed = read_launches(ops)
            if losses.shape != (full,) or not torch.isfinite(losses).all():
                raise AssertionError(f"[resident] {label} fused: losses {losses}")
            diffs = (losses - eager_losses).abs()
            diff = diffs.max().item()
            differ = torch.nonzero(diffs).flatten().tolist()
            if diff > FUSED_TOL:
                raise AssertionError(f"[resident] {label} fused: max |fused - eager| loss {diff!r} > {FUSED_TOL}")
            launches = int(per_step) * full
            out[f"fused_{label}"] = {
                "ms_per_batch": fused_ms / full, "rows_per_s": b * full / (fused_ms / 1e3),
                "max_abs_loss_diff": diff, "bit_equal": not differ, "first_differing_step": differ[0] if differ else None,
                "capture_s": capture_s, "k1_launches": launches, "python_launches_in_replays": replayed,
            }
            log(f"[resident] fused {label} epoch 1 (one CUDA graph, {full} replays): {fused_ms / full!r} ms per "
                f"batch, {out[f'fused_{label}']['rows_per_s']!r} rows/s; max |fused - eager| loss {diff!r} "
                f"(bit-equal: {not differ}; {len(differ)} of {full} steps differ, the first at step "
                f"{differ[0] if differ else None}); warm-up and capture {capture_s!r} s; "
                f"K1 launches on this path: {int(per_step)} captured x {full} replays = {launches}, all on the "
                f"tensor-core route ({resident.FUSED_WARMUP_STEPS} more in the warm-up; the wrappers count "
                f"Python calls, and replays make none: {replayed['interaction']})")
        out["k1_launches"] = out["fused_materialized"]["k1_launches"]
        for ds in datasets.values():
            ds.close()
        out["trial"] = collector.call("get_stats", 60)
        log(trial_line("resident materialized", out["trial"]) + f" ({smi})")
    finally:
        port.runtime.shutdown()
    return out


def phase_lm(torch) -> dict:
    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops

    steps = 20
    model = port.CausalLM(vocab_size=64, max_seq_len=512, embed_dim=64, num_layers=2, num_heads=4)
    opt = port.make_optimizer(model, lr=3e-3)
    tokens = torch.from_numpy(port.synthetic_tokens(4, 512, 64, seed=0)).to("cuda")
    reset_launches(ops)
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = port.next_token_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = read_launches(ops)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"lm: loss did not fall: {losses}")
    want = 2 * steps
    # t = 512, hd = 16, bf16: the tensor-core route only.
    if launches["interaction"] or any(
        launches[k] != want
        for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_mma", "flash_bwd_dkv_mma",
                  "flash_bwd_dq_mma")
    ):
        raise AssertionError(f"lm: launches {launches}, want {want} of each flash kernel, "
                             f"all on the tensor-core route")
    median_ms = statistics.median(step_s[1:]) * 1e3
    log(f"[lm] {steps} steps, loss {losses[0]!r} -> {losses[-1]!r}; step median {median_ms!r} ms "
        f"(first {step_s[0] * 1e3!r} ms); launches {launches}")
    return {"losses": losses, "step_ms_median": median_ms, "launches": launches}


def phase_parity(torch, label: str, model, batch):
    """``(max |cuda - cpu|, launches of the fp32 forward on cuda)``; the
    interaction and the flash kernels take their CUDA-core routes there."""
    import ray_shuffling_data_loader_tpu_torch.ops as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = 8192
    features = {k: v[:rows] for k, v in batch[0].items()}
    model.compute_dtype = torch.float32
    with torch.no_grad():
        reset_launches(ops)
        on_gpu = model(features).cpu()
        launches = read_launches(ops)
        cpu_model = copy.deepcopy(model).to("cpu")
        on_cpu = cpu_model({k: v.cpu() for k, v in features.items()})
    err = (on_gpu - on_cpu).abs().max().item()
    torch.testing.assert_close(on_gpu, on_cpu, **PARITY_TOL)
    # A forward: K1 once, or K2 once per encoder layer.
    want = {"interaction": 1} if label == "dlrm" else {"flash_fwd": 2}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"parity {label}: launches {launches}, want {want}, all on the "
                             f"CUDA-core route")
    log(f"[parity] {label}: {rows} rows fp32, cuda vs cpu: max |diff| = {err!r} "
        f"(atol {PARITY_TOL['atol']}, rtol {PARITY_TOL['rtol']}); launches {launches}")
    return err, launches


# The pod phase: pod.py as four gloo ranks on cuda:0, a global batch of
# 65536 (16384 a rank) on the slices' dataset.
POD_RANKS = 4
POD_EPOCHS = 2
# Step 0 against one process on the same weights and global batch: the
# forward is the same per row, and only the mean's order of summation and
# the matmuls' tiling at 16384 rows differ. Later steps part by Adam's
# updates on gradients summed in another order.
POD_STEP0_TOL = 1e-4
POD_LOSS_TOL = 1e-2
POD_TIMEOUT_S = 300


def phase_pod(torch, filenames, data_dir: str, smi: str, work: str) -> dict:
    """The pod trainer and the resident loader over processes (docstring,
    phase 10)."""
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port

    t_phase = time.perf_counter()
    b = 65536
    full = NUM_ROWS // b
    shard = b // POD_RANKS
    # pod.py's rank 0 reuses a data directory whose manifest names this shape.
    with open(os.path.join(data_dir, "manifest.json"), "w") as f:
        json.dump({"shape": {"num_rows": NUM_ROWS, "num_files": 10, "row_groups": 5, "seed": 0},
                   "files": [os.path.abspath(fn) for fn in filenames]}, f)
    out_dir = os.path.join(work, "out")
    cmd = [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.pod", "--simulate-pod", str(POD_RANKS),
           "--loader", "resident", "--backend", "gloo", "--device", "cuda", "--num-rows", str(NUM_ROWS),
           "--num-files", "10", "--row-groups", "5", "--seed", "0", "--batch-size", str(b), "--epochs",
           str(POD_EPOCHS), "--embed-dim", "32", "--vocab-cap", "0", "--data-dir", data_dir, "--fused-from-epoch",
           "1", "--check-gather", "--num-workers", "2", "--out", out_dir, "--rendezvous-dir",
           os.path.join(work, "rdv"), "--timeout", str(POD_TIMEOUT_S)]
    env = {k: v for k, v in os.environ.items() if k != "RSDL_RUNTIME_DIR"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, timeout=POD_TIMEOUT_S + 30)
    pod_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[pod] pod.py exited {proc.returncode}")
    ranks = []
    for r in range(POD_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    def joined(name):
        parts = [np.load(os.path.join(out_dir, f"rank{r}-{name}.npy")).reshape(-1, shard) for r in range(POD_RANKS)]
        return np.concatenate(parts, axis=1).reshape(-1)

    # The one-process stream and an eager DLRM on it from the same weights.
    key = port.KEY_COLUMN
    columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN] + [key]
    port.runtime.init(num_workers=4)
    try:
        ds = port.DeviceResidentShufflingDataset(filenames, POD_EPOCHS, b, columns, port.LABEL_COLUMN, seed=0,
                                                 device="cuda")
        torch.manual_seed(0)
        model = port.dlrm_for_data_spec(device="cpu").to("cuda")
        step = port.make_train_step(model, port.make_optimizer(model))
        want_keys, ref_losses = [], []
        for epoch in range(POD_EPOCHS):
            ds.set_epoch(epoch)
            keys = []
            for feats, labels in ds:
                keys.append(feats.pop(key))
                ref_losses.append(step(feats, labels)["loss"])
            want_keys.append(torch.cat(keys).cpu().numpy())
        ref_losses = torch.stack(ref_losses).tolist()
        ds.close()
    finally:
        port.runtime.shutdown()
    for epoch in range(POD_EPOCHS):
        got = joined(f"epoch{epoch}")
        if got.size != full * b or np.unique(got).size != got.size:
            raise AssertionError(f"[pod] epoch {epoch}: {got.size} keys, {np.unique(got).size} distinct; want "
                                 f"{full * b} once each")
        if not np.array_equal(got, want_keys[epoch]):
            raise AssertionError(f"[pod] epoch {epoch}: the joined shards differ from the one-process stream")
    if not np.array_equal(joined("gather-epoch0"), want_keys[0]):
        raise AssertionError("[pod] gather schedule, epoch 0: the joined shards differ from the one-process stream")
    if not all(res["fits_device"] for res in ranks):
        raise AssertionError(f"[pod] fits_device (pod-consistent): {[res['fits_device'] for res in ranks]}")
    if len({res["materialize"] for res in ranks}) != 1 or any(res["gather"]["materialize"] for res in ranks):
        raise AssertionError(f"[pod] schedules differ across ranks: {[res['materialize'] for res in ranks]}")
    if len({res["params_sha256"] for res in ranks}) != 1:
        raise AssertionError("[pod] the ranks ended with different parameters")
    losses = [x for epoch in ranks[0]["losses"] for x in epoch]
    if any(res["losses"] != ranks[0]["losses"] for res in ranks) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[pod] the ranks logged different or non-finite losses: {[r['losses'] for r in ranks]}")
    if len(losses) != len(ref_losses):
        raise AssertionError(f"[pod] {len(losses)} steps, the one process {len(ref_losses)}")
    diffs = [abs(a - w) for a, w in zip(losses, ref_losses)]
    if not (diffs[0] <= POD_STEP0_TOL and max(diffs) <= POD_LOSS_TOL):
        raise AssertionError(f"[pod] losses {losses} against one process's {ref_losses}: step 0 differs by "
                             f"{diffs[0]!r} (tolerance {POD_STEP0_TOL}), the largest by {max(diffs)!r} "
                             f"(tolerance {POD_LOSS_TOL})")
    for res in ranks:
        n = res["launches"]
        if n["interaction_mma"] != POD_EPOCHS * full or n["interaction_all_routes"] != n["python_calls"]:
            raise AssertionError(f"[pod] rank {res['rank']}: K1 launches {n}, want {POD_EPOCHS * full}, all on the "
                                 "tensor-core route")
    launches = sum(res["launches"]["interaction_mma"] for res in ranks)
    wall = time.perf_counter() - t_phase
    for res in ranks:
        log(f"[pod] rank {res['rank']} ({res['device']}): staged {res['bytes_staged']} B ({res['span_rows']} rows) "
            f"in {res['staging_s']!r} s; materialized exchange {res['exchange_s']['0']!r} s in epoch 0; gather "
            f"schedule {res['gather']['exchange_s']!r} s of exchanges in its epoch 0 ({res['gather']['epoch_s']!r} s "
            f"delivered); step median {res['step_ms_median']!r} ms (eager); eager {res['eager_ms_per_batch']!r} "
            f"ms a batch, fused {res['fused_ms_per_batch']!r} ms a batch (collectives {res['fused_comm_share']!r} of "
            f"it; capture {res['capture_s']!r} s); spawn to first step {res['startup_s']['first_step']!r} s; K1 "
            f"{res['launches']}; peak device memory {res['peak_device_bytes']} B ({smi})")
    log(f"[pod] {POD_RANKS} ranks, 2 epochs: joined shards == the one-process stream on both schedules, "
        f"{full * b} keys once each an epoch; losses within {POD_STEP0_TOL} at step 0 ({diffs[0]!r}) and "
        f"{POD_LOSS_TOL} after (max |pod - one process| {max(diffs)!r}); parameters bit-identical; K1 {launches} "
        f"launches ({POD_EPOCHS * full} a rank); pod.py {pod_s:.1f} s, phase {wall:.1f} s ({smi})")
    return {"ranks": ranks, "launches": launches, "loss_diffs": diffs, "pod_s": pod_s, "wall_s": wall}


# The child of the resume phase: the trainer, whose train step this code
# wraps to SIGKILL the child's process group (the trainer, its shuffle
# workers and its queue actor) once KILL_AFTER_STEP steps have trained.
RESUME_CHILD = r"""
import os, signal, sys
sys.path.insert(0, os.environ["RESUME_ROOT"])

if __name__ == "__main__":
    kill_after = int(os.environ.get("KILL_AFTER_STEP", "0"))
    if kill_after:
        import ray_shuffling_data_loader_tpu_torch.parallel as parallel

        make = parallel.make_train_step

        def make_train_step(*a, **k):
            step = make(*a, **k)
            count = [0]

            def killing_step(*sa, **sk):
                out = step(*sa, **sk)
                count[0] += 1
                if count[0] == kill_after:
                    float(out["loss"])
                    os.killpg(os.getpgid(0), signal.SIGKILL)
                return out

            return killing_step

        parallel.make_train_step = make_train_step
    from ray_shuffling_data_loader_tpu_torch import train_dlrm

    sys.exit(train_dlrm.main(sys.argv[1:]))
"""
RESUME_BATCH, RESUME_EPOCHS, RESUME_EVERY, RESUME_KILL = 65536, 2, 8, 10
RESUME_LOSS_TOL = 1e-5  # PERF.md's bound: the embedding backward's atomics


# Pool workers of each trainer's session: up to three trainers run side by side.
RESUME_WORKERS = 4


def resume_run(work: str, shm: str, name: str, loader: str, kill_after: int = 0, checkpoint: bool = True,
               env_extra=None) -> dict:
    """One trainer child (``work/child.py``, :data:`RESUME_CHILD`) in a
    session of its own: its exit code, RESULT, records per step and the unix
    time it started."""
    import numpy as np

    script = os.path.join(work, "child.py")
    record = os.path.join(work, f"rec-{name}")
    shutil.rmtree(record, ignore_errors=True)
    argv = [sys.executable, script, "--num-rows", str(NUM_ROWS), "--num-files", "10", "--num-row-groups-per-file",
            "5", "--batch-size", str(RESUME_BATCH), "--epochs", str(RESUME_EPOCHS), "--num-reducers", "8",
            "--seed", "0", "--data-dir", os.path.join(work, "data"), "--loader", loader, "--device", "cuda",
            "--checkpoint-every", str(RESUME_EVERY), "--record", record, "--num-workers", str(RESUME_WORKERS)]
    if checkpoint:
        argv += ["--checkpoint-dir", os.path.join(work, f"ckpt-{loader}")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env.update(RESUME_ROOT=ROOT, KILL_AFTER_STEP=str(kill_after), RSDL_SHM_DIR=shm, **(env_extra or {}))
    started = time.time()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=work,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        try:
            os.killpg(proc.pid, 9)  # whatever of the child's group is left
        except ProcessLookupError:
            pass
        proc.wait()
    steps = {}
    path = os.path.join(record, "steps.jsonl")
    if os.path.exists(path):
        for line in open(path):
            rec = json.loads(line)
            rec["keys"] = np.load(os.path.join(record, f"keys-{rec['step']:06d}.npy"))
            steps[rec["step"]] = rec
    results = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return {"rc": proc.returncode, "result": json.loads(results[-1][7:]) if results else None, "steps": steps,
            "started": started, "stdout": out, "stderr": err}


def check_resumed_launches(label: str, run: dict, steps: int) -> None:
    res = run["result"]
    if res["interaction_launches"] != steps or res["interaction_mma_launches"] != steps:
        raise AssertionError(f"[resume] {label}: K1 launches {res['interaction_launches']} "
                             f"(tensor-core {res['interaction_mma_launches']}) in {steps} steps, want one per step "
                             "on the tensor-core route")


def phase_resume(torch, work: str, smi: str, filenames) -> dict:
    """The trainer preempted and resumed (docstring, phase 9), on the
    slices' dataset ``filenames``."""
    # A directory of its own on the shared-memory filesystem, so that what
    # the sessions leave there can be counted.
    shm = os.path.join("/dev/shm" if os.path.isdir("/dev/shm") else work, f"chip-smoke-resume-{os.getpid()}")
    os.makedirs(shm)
    try:
        return _phase_resume(torch, work, shm, smi, filenames)
    finally:
        shutil.rmtree(shm, ignore_errors=True)


def _phase_resume(torch, work: str, shm: str, smi: str, filenames) -> dict:
    import numpy as np

    from ray_shuffling_data_loader_tpu_torch.train_dlrm import get_data, parse_args
    from ray_shuffling_data_loader_tpu_torch.utils.prng import epoch_permutation

    per_epoch = NUM_ROWS // RESUME_BATCH
    total = per_epoch * RESUME_EPOCHS
    ckpt_step = RESUME_KILL // RESUME_EVERY * RESUME_EVERY
    loaders = ("mapreduce", "resident")
    out = {}

    def expect(cond, what, run=None):
        if not cond:
            tail = f"\n{run['stdout'][-3000:]}\n{run['stderr'][-3000:]}" if run else ""
            raise AssertionError(f"[resume] {what}{tail}")

    # The runs that do not depend on each other run side by side (each
    # trainer pays seconds of start-up): the control and both victims, and
    # each resume as soon as its own victim is dead. Each keeps its own shm
    # directory and journal; the dataset and the child script are written
    # once first.
    with open(os.path.join(work, "child.py"), "w") as f:
        f.write(RESUME_CHILD)
    # The trainers' data directory names the slices' files, which are this
    # shape, in the manifest through which get_data reuses a dataset.
    os.makedirs(os.path.join(work, "data"))
    with open(os.path.join(work, "data", "manifest.json"), "w") as f:
        json.dump({"shape": {"num_rows": NUM_ROWS, "num_files": 10, "row_groups": 5, "seed": 0},
                   "files": [os.path.abspath(fn) for fn in filenames]}, f)
    args = parse_args(["--num-rows", str(NUM_ROWS), "--num-files", "10", "--num-row-groups-per-file", "5",
                       "--seed", "0", "--data-dir", os.path.join(work, "data")])
    if get_data(args) != [os.path.abspath(fn) for fn in filenames]:
        raise AssertionError("[resume] the trainers would not reuse the slices' dataset")
    shms = {name: os.path.join(shm, name) for name in ("control", *loaders)}
    for d in shms.values():
        os.makedirs(d)
    journal = {loader: {"RSDL_JOURNAL": os.path.join(work, f"journal-{loader}")} for loader in loaders}
    def victim_then_resume(loader):
        victim = resume_run(work, shms[loader], f"victim-{loader}", loader, kill_after=RESUME_KILL,
                            env_extra=journal[loader])
        t_victim = time.perf_counter() - t_round
        return victim, t_victim, resume_run(work, shms[loader], f"resume-{loader}", loader,
                                            env_extra={**journal[loader], "RSDL_RESUME": "redeliver"})

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        t_round = time.perf_counter()
        control_fut = pool.submit(resume_run, work, shms["control"], "control", "mapreduce", checkpoint=False)
        chains = {loader: pool.submit(victim_then_resume, loader) for loader in loaders}
        first, second = {"control": control_fut.result()}, {}
        rounds_s = [time.perf_counter() - t_round]
        for loader, fut in chains.items():
            first[loader], victim_s, second[loader] = fut.result()
            rounds_s.append(victim_s)
        rounds_s.append(time.perf_counter() - t_round)
    control = first["control"]
    expect(control["rc"] == 0 and sorted(control["steps"]) == list(range(1, total + 1)),
           f"control: exit {control['rc']}, steps {sorted(control['steps'])}", control)
    expect(all(math.isfinite(r["loss"]) for r in control["steps"].values()), "control: a loss is not finite")
    check_resumed_launches("control", control, total)
    left = sorted(os.listdir(shms["control"]))
    expect(not left, f"control: segments left in its shm directory: {left[:5]} ({len(left)})")
    for loader in loaders:
        victim = first[loader]
        expect(victim["rc"] == -9, f"{loader} victim: exit {victim['rc']}, want SIGKILL", victim)
        # The child dies inside step RESUME_KILL, before recording it.
        expect(sorted(victim["steps"]) == list(range(1, RESUME_KILL)), f"{loader} victim: steps {sorted(victim['steps'])}")
        replayed = RESUME_KILL - ckpt_step
        resumed = second[loader]
        res = resumed["result"]
        expect(resumed["rc"] == 0 and res is not None, f"{loader} resume: exit {resumed['rc']}", resumed)
        expect(f"resuming from step {ckpt_step}" in resumed["stdout"], f"{loader} resume did not start at {ckpt_step}",
               resumed)
        want = list(range(ckpt_step + 1, total + 1))
        expect(sorted(resumed["steps"]) == want, f"{loader} resume: steps {sorted(resumed['steps'])}")
        check_resumed_launches(f"{loader} resume", resumed, len(want))
        worst, perms = 0.0, {}
        for s in want:
            got = resumed["steps"][s]
            if loader == "mapreduce":
                ref = control["steps"][s]
                expect(np.array_equal(got["keys"], ref["keys"]), f"mapreduce step {s}: keys differ from the control's")
                worst = max(worst, abs(got["loss"] - ref["loss"]))
            else:
                epoch, b = got["epoch"], got["batch"]
                if epoch not in perms:
                    perms[epoch] = epoch_permutation(0, epoch, NUM_ROWS, device="cpu").numpy()
                perm = perms[epoch]
                expect(np.array_equal(got["keys"], perm[b * RESUME_BATCH:(b + 1) * RESUME_BATCH]),
                       f"resident step {s}: keys differ from epoch_permutation(0, {epoch})")
                expect(math.isfinite(got["loss"]), f"resident step {s}: loss {got['loss']}")
        expect(worst <= RESUME_LOSS_TOL, f"mapreduce: max |resumed - control| loss {worst!r} > {RESUME_LOSS_TOL}")
        counters = res.get("resume") or {}
        reattached = counters.get("maps_reattached", 0) + counters.get("reduces_reattached", 0)
        reexecuted = counters.get("maps_reexecuted", 0) + counters.get("reduces_reexecuted", 0)
        if loader == "mapreduce":
            expect(counters.get("mode") == "redeliver" and counters.get("from_run"), f"no journal resumed: {counters}")
            expect(reattached > 0, f"mapreduce resume re-attached no stage: {counters}")
        left = sorted(os.listdir(shms[loader]))
        if loader == "mapreduce":
            expect(not left, f"mapreduce: segments left in the shm directory: {left[:5]} ({len(left)})")
        for name in left:  # the resident loader journals nothing: a killed run's leftovers are not swept
            os.unlink(os.path.join(shms[loader], name))
        restart_s = res["first_batch_at"] - resumed["started"]
        ck = resumed["result"]["checkpoint_bytes"]
        log(f"[resume] {loader}: checkpoint {ck[0] if ck else None} B, save "
            f"{[round(x, 4) for x in res['checkpoint_save_s']]!r} s (fsync included); restore {res['restore_s']!r} s; "
            f"restart to first batch {restart_s!r} s ({res['first_batch_s']!r} s after main()); stages re-attached "
            f"{reattached} (maps {counters.get('maps_reattached', 0)}, reduces {counters.get('reduces_reattached', 0)}), "
            f"re-executed {reexecuted}; steps replayed {replayed} (victim killed after step {RESUME_KILL}, "
            f"checkpoint {ckpt_step}); K1 launches {res['interaction_launches']} in {len(want)} steps; "
            f"max |loss - control| {worst!r}; segments left {len(left)}; {counters}; start-up (s since main(), "
            f"cumulative) {res['startup_s']} ({smi})")
        out[loader] = {
            "checkpoint_bytes": ck, "checkpoint_save_s": res["checkpoint_save_s"], "restore_s": res["restore_s"],
            "restart_to_first_batch_s": restart_s, "first_batch_s": res["first_batch_s"], "resume": counters,
            "steps_replayed": replayed, "k1_launches": res["interaction_launches"], "steps_trained": len(want),
            "max_loss_diff": worst, "stall_s": res["stall_s"], "segments_left": len(left),
            "startup_s": res["startup_s"],
        }
        shutil.rmtree(os.path.join(work, f"ckpt-{loader}"), ignore_errors=True)
    out["control"] = {"k1_launches": control["result"]["interaction_launches"], "steps": total,
                      "first_batch_s": control["result"]["first_batch_s"], "startup_s": control["result"]["startup_s"]}
    out["rounds_s"] = rounds_s
    log(f"[resume] control: {total} steps, K1 launches {control['result']['interaction_launches']}, start-up "
        f"{control['result']['startup_s']}; resumed key "
        f"streams equal the control's (mapreduce) and epoch_permutation's (resident) bit for bit; s from the start "
        f"to the control's end, to each victim's death (mapreduce, resident; its resume starts then) and to the "
        f"last resume's end {rounds_s!r} ({smi})")
    return out


# -- sequence parallelism ------------------------------------------------------------

# (a) the ops on one group of 4 gloo ranks on the card, at the CausalLM's
# global shape and the long one; (schedule, causal) cases.
SP_OP_WORLD = 4
SP_OP_SHAPES = (("lm", LM_SHAPE), ("long", LONG_SHAPE))
SP_OP_CASES = (("ring", False), ("ring", True), ("ulysses", True))
# Kernels against the same op's plain tensor code, both bf16 on the card.
# The ring's flash hops return their block bf16, merged in fp32, where the
# plain hops keep fp32 to the end: out may part by two bf16 roundings (2**-8
# of the value each) of values up to max |v| ~ 4, hence atol 2e-2; the
# gradients inherit one rounding from out (through D = rowsum(dO ⊙ out)).
SP_KERNEL_TOL = dict(atol=2e-2, rtol=2**-6)
# Against one process's fp32 dense attention on the same bf16 inputs:
# tests/test_ring_attention.py's bf16 tolerance.
SP_REF_TOL = dict(atol=5e-2, rtol=5e-2)
SP_TIME_REPS = 3
# (b) the slice: train_long_context at its defaults, ring then Ulysses.
SP_ATTENTIONS = ("ring", "ulysses")
# Step 0 of the 8 ranks against one process's CausalLM on the same weights
# and tokens, both bf16: other roundings of bf16 activations move the mean
# loss (about 4.2) by a few bf16 steps of the logits, averaged over 2,044
# positions a row.
SP_LOSS_TOL = 2e-3


def _sp_fwd_bwd(torch, fn, q, k, v, dout):
    """``(out, dq, dk, dv)`` of ``fn`` on fresh leaves, synchronized."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    return out.detach(), *(x.grad for x in leaves)


def _sp_ms(torch, fn, q, k, v, dout) -> float:
    """Median host ms of one forward and backward of ``fn`` (synchronized),
    after one warm-up; every rank of the group calls it alike."""
    _sp_fwd_bwd(torch, fn, q, k, v, dout)
    times = []
    for _ in range(SP_TIME_REPS):
        t0 = time.perf_counter()
        _sp_fwd_bwd(torch, fn, q, k, v, dout)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sp_op_rank(spec: dict, rank: int) -> int:
    """Rank ``rank`` of the ``[sp]`` phase's op group: each case's kernels
    against its plain tensor code and against fp32 dense attention, the
    K2–K4 launches of the kernel version, ms of each version and of the
    dense op, and at the long shape the peak device bytes of the causal
    ring and of the dense op. Raises on a disagreement or a wrong count."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.parallel import init_data_parallel
    from ray_shuffling_data_loader_tpu_torch.train_long_context import dense_attention

    torch.cuda.set_device(0)
    world = spec["world"]
    init_data_parallel(rank, world, "gloo", spec["init_method"])
    group = dist.group.WORLD
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "shapes": {}}
    for shape_name, shape in SP_OP_SHAPES:
        b, t, h, hd = shape
        tl = t // world
        gen = torch.Generator().manual_seed(7)  # the same global inputs on every rank
        q, k, v, dout = (torch.randn(shape, generator=gen).to("cuda", torch.bfloat16) for _ in range(4))
        rows = slice(rank * tl, (rank + 1) * tl)
        local = [x[:, rows].contiguous() for x in (q, k, v, dout)]
        res, refs = {}, {}
        for schedule, causal in SP_OP_CASES:
            label = f"{schedule}_{'causal' if causal else 'full'}"
            make = ops.make_ring_attention if schedule == "ring" else ops.make_ulysses_attention
            reset_launches(ops)
            got = _sp_fwd_bwd(torch, make(group, causal=causal, use_flash=True), *local)
            launches = read_launches(ops)
            plain = _sp_fwd_bwd(torch, make(group, causal=causal, use_flash=False), *local)
            if any(read_launches(ops)[key] != n for key, n in launches.items()):
                raise AssertionError(f"[sp] rank {rank} {shape_name} {label}: the plain version launched a kernel")
            if schedule == "ring":
                fwd = rank + 1 if causal else world
                want = {"flash_fwd": fwd, "flash_fwd_mma": fwd}
            else:
                want = {f"{kname}{suffix}": 1 for kname in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
                        for suffix in ("", "_mma")}
            if any(launches[key] != want.get(key, 0) for key in launches):
                raise AssertionError(f"[sp] rank {rank} {shape_name} {label}: launches {launches}, want {want} "
                                     "(all on the tensor-core route)")
            if causal not in refs:  # one process's fp32 dense attention on the whole sequence
                leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
                ref_out = ops.attention_reference(*leaves, causal=causal)
                ref_out.backward(dout.float())
                refs[causal] = [x[:, rows].contiguous() for x in (ref_out.detach(), *(x.grad for x in leaves))]
                del leaves, ref_out
            want_ref = refs[causal]
            keys = ("out", "dq", "dk", "dv")
            errs = compare(torch, f"[sp] rank {rank} {shape_name} {label} kernels vs plain",
                           [(key, g, p, SP_KERNEL_TOL) for key, g, p in zip(keys, got, plain)])
            ref_errs = compare(torch, f"[sp] rank {rank} {shape_name} {label} kernels vs fp32 dense",
                               [(key, g.float(), w, SP_REF_TOL) for key, g, w in zip(keys, got, want_ref)])
            res[label] = {
                "launches": launches, "max_abs_err_plain": errs, "max_abs_err_reference": ref_errs,
                "ms": _sp_ms(torch, make(group, causal=causal, use_flash=True), *local),
                "plain_ms": _sp_ms(torch, make(group, causal=causal, use_flash=False), *local),
            }
        res["dense_causal_ms"] = _sp_ms(torch, dense_attention(group, rank), *local)
        if shape_name == "long":
            for label, fn in (("ring", ops.make_ring_attention(group, causal=True)),
                              ("dense", dense_attention(group, rank))):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _sp_fwd_bwd(torch, fn, *local)
                res[f"{label}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            if not res["ring_peak_bytes"] < res["dense_peak_bytes"]:
                raise AssertionError(f"[sp] rank {rank}: the ring's peak {res['ring_peak_bytes']} B is not below "
                                     f"the dense op's {res['dense_peak_bytes']} B")
        out["shapes"][shape_name] = res
        del q, k, v, dout, local, refs, want_ref
        torch.cuda.empty_cache()
    with open(os.path.join(spec["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _sp_op_group(work: str) -> list:
    """Spawn the op group's ranks (this script with ``--sp-op-rank``) and
    return their results; a failed rank fails the phase."""
    from ray_shuffling_data_loader_tpu_torch.multirank import _free_port, wait_ranks

    spec = {"world": SP_OP_WORLD, "init_method": f"tcp://localhost:{_free_port()}", "out_dir": work}
    spec_path = os.path.join(work, "sp_ops.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sp-op-rank", str(r), "--sp-spec",
                               spec_path]) for r in range(SP_OP_WORLD)]
    returncode, codes = wait_ranks(procs, 300)
    if returncode:
        raise AssertionError(f"[sp] op group: exit code {returncode}, rank exit codes {codes}")
    return [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(SP_OP_WORLD)]


def phase_sp(torch, work: str, smi: str) -> dict:
    """Sequence parallelism (docstring, phase 7): the ops on 4 ranks, then
    the long-context trainer on 8."""
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import train_long_context

    t_phase = time.perf_counter()
    ops_out = _sp_op_group(work)
    for res in ops_out:
        for shape_name, shape in SP_OP_SHAPES:
            r = res["shapes"][shape_name]
            for label, c in ((k_, v_) for k_, v_ in r.items() if isinstance(v_, dict)):
                log(f"[sp] rank {res['rank']} {shape_name} {list(shape)} bf16 {label}: kernels vs plain max |diff| "
                    f"{c['max_abs_err_plain']} ({SP_KERNEL_TOL}); vs fp32 dense {c['max_abs_err_reference']} "
                    f"({SP_REF_TOL}); launches {c['launches']}; fwd+bwd {c['ms']!r} ms, plain {c['plain_ms']!r} ms")
            log(f"[sp] rank {res['rank']} {shape_name}: dense causal (all-gather + attention_reference) fwd+bwd "
                f"{r['dense_causal_ms']!r} ms"
                + (f"; peak device bytes over the inputs: ring causal {r['ring_peak_bytes']}, dense "
                   f"{r['dense_peak_bytes']}" if shape_name == "long" else ""))
    t_ops = time.perf_counter() - t_phase
    # (b) the slice at its defaults, ring then Ulysses in one spawn of the ranks.
    args = train_long_context.parse_args(["--backend", "gloo", "--attention", *SP_ATTENTIONS, "--timeout", "300"])
    t0 = time.perf_counter()
    run = train_long_context.run(args)
    wall = time.perf_counter() - t0
    if run["returncode"] != 0:
        raise AssertionError(f"[sp] train_long_context: exit code {run['returncode']}: {run['problems']}")
    model = port.CausalLM(args.vocab, args.seq_len, embed_dim=args.embed_dim, num_layers=args.layers,
                          num_heads=args.heads)
    tokens = torch.from_numpy(port.synthetic_tokens(args.batch, args.seq_len, args.vocab, seed=args.seed)).to("cuda")
    with torch.no_grad():
        one_process = port.next_token_loss(model(tokens), tokens).item()
    steps = args.steps
    runs = {}
    for i, attention in enumerate(SP_ATTENTIONS):
        first = run["ranks"][0]["runs"][i]
        if not abs(first["losses"][0] - one_process) <= SP_LOSS_TOL:
            raise AssertionError(f"[sp] {attention}: step 0's loss {first['losses'][0]!r} against one process's "
                                 f"{one_process!r}: more than {SP_LOSS_TOL} apart")
        for res in run["ranks"]:
            r = res["runs"][i]
            n = r["launches"]
            if attention == "ring":
                want = {"flash_fwd": 2 * (res["sp_index"] + 1) * steps}
                want["flash_fwd_mma"] = want["flash_fwd"]
            else:
                want = {key: 2 * steps for key in n}
            if any(n[key] != want.get(key, 0) for key in n):
                raise AssertionError(f"[sp] {attention} rank {res['rank']}: launches {n} in {steps} steps, "
                                     f"want {want} (two layers; all on the tensor-core route)")
            log(f"[sp] {attention} rank {res['rank']} (data {res['data_index']}, sp {res['sp_index']}; "
                f"{res['device']}): step median {r['step_ms_median']!r} ms (first {r['step_ms'][0]!r} ms), "
                f"collectives {r['comm_share']!r} of a step (median); peak device {r['peak_device_bytes']} B; "
                f"launches {n}; losses {r['losses'][0]!r} -> {r['losses'][-1]!r}")
        runs[attention] = {
            "losses": first["losses"],
            "step_ms_median": statistics.median(res["runs"][i]["step_ms_median"] for res in run["ranks"]),
            "comm_share": statistics.median(res["runs"][i]["comm_share"] for res in run["ranks"]),
            "launches": {key: sum(res["runs"][i]["launches"][key] for res in run["ranks"])
                         for key in first["launches"]},
        }
        log(f"[sp] {attention}: {steps} steps on dp 2 x sp 4 gloo ranks, loss {first['losses'][0]!r} -> "
            f"{first['losses'][-1]!r}; step 0 within {abs(first['losses'][0] - one_process)!r} of one process's "
            f"{one_process!r}; parameters bit-identical on all 8 ranks ({first['params_sha256'][:16]}); "
            f"launches over the ranks {runs[attention]['launches']} ({smi})")
    for res in run["ranks"]:
        marks = res["startup_s"]
        log(f"[sp] rank {res['rank']} start-up, s since spawn: " + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()))
    out = {"ops": ops_out, "train": runs, "one_process_loss": one_process, "ranks": run["ranks"],
           "spawn_to_first_step_s": max(res["startup_s"]["first_step"] for res in run["ranks"]),
           "ops_s": t_ops, "train_s": wall, "wall_s": time.perf_counter() - t_phase}
    log(f"[sp] phase {out['wall_s']:.1f} s (ops {t_ops:.1f} s, trainer {wall:.1f} s; spawn to first step "
        f"{out['spawn_to_first_step_s']:.1f} s)")
    return out


# Each phase's wall seconds, as main() ran them.
WALLS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name`` in :data:`WALLS`."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        WALLS[name] = time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    # A rank of the sp phase's op group.
    parser.add_argument("--sp-op-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--sp-spec", default=None, help=argparse.SUPPRESS)
    # The cluster phase's head.
    parser.add_argument("--cluster-head", default=None, help=argparse.SUPPRESS)
    # The fault phase's head.
    parser.add_argument("--faults-head", default=None, help=argparse.SUPPRESS)
    # The telemetry phase's head.
    parser.add_argument("--telemetry-head", default=None, help=argparse.SUPPRESS)
    # The obs phase's head.
    parser.add_argument("--obs-head", default=None, help=argparse.SUPPRESS)
    # The elastic phase's head.
    parser.add_argument("--elastic-head", default=None, help=argparse.SUPPRESS)
    # A run of the ranks phase.
    parser.add_argument("--ranks-run", default=None, help=argparse.SUPPRESS)
    # The service phase's head.
    parser.add_argument("--service-head", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--pool-ready", default=None, metavar="ROOT",
                        help="only time fresh 8-worker pools of the checkout at ROOT (its ready_s) and exit")
    args = parser.parse_args()
    if args.ranks_run is not None:  # a launcher: its ranks import torch, it need not
        with open(args.ranks_run) as f:
            return ranks_run(json.load(f))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.sp_op_rank is not None:
        with open(args.sp_spec) as f:
            return sp_op_rank(json.load(f), args.sp_op_rank)
    heads = {"cluster": cluster_head, "faults": faults_head, "telemetry": telemetry_head, "obs": obs_head,
             "elastic": elastic_head, "service": service_head}
    for head, fn in heads.items():
        if getattr(args, f"{head}_head") is not None:
            return run_head(fn, getattr(args, f"{head}_head"))
    if args.pool_ready is not None:
        return pool_ready(args.pool_ready)
    sys.path.insert(0, ROOT)
    name = torch.cuda.get_device_name(0)
    smi = smi_name_and_limit()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; start-up "
        f"{time.perf_counter() - T_PROCESS:.1f} s")
    data_dir = os.path.join(ROOT, "build", "smoke_data")
    t_start = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as lint_pool:
            pending_lint = start_lint(lint_pool)
            timed("build", phase_build)
            lint = timed("lint", phase_lint, *pending_lint)
        host = timed("native", phase_native)
        # The plain versions' fp32 products must not round their inputs to TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        rate, rate_src, measured = memory_rate(torch, name)
        log(f"[kernel] bounds use {rate:.4g} B/s ({rate_src}); measured copy rate {measured:.4g} B/s")
        kernels = timed("interaction", phase_interaction, torch, rate, rate_src)
        flash_entries, flash = timed("flash", phase_flash, torch, rate)
        kernels += flash_entries
        log(f"[kernel] done at {time.perf_counter() - t_start:.1f} s")
        shutil.rmtree(data_dir, ignore_errors=True)
        try:
            slices = timed("slices", phase_slices, torch, data_dir)
            filenames = slices.pop("filenames")
            delivery = timed("delivery", phase_delivery, torch, filenames, NUM_ROWS)
            uri_dirs = [os.path.join(ROOT, "build", d) for d in ("uri_data", "uri_stats")]
            for d in uri_dirs:
                shutil.rmtree(d, ignore_errors=True)
            try:
                uri = timed("uri", phase_uri, torch, filenames, slices["dlrm"], *uri_dirs)
            finally:
                for d in uri_dirs:
                    shutil.rmtree(d, ignore_errors=True)
            ranks_dir = os.path.join(ROOT, "build", "ranks")
            shutil.rmtree(ranks_dir, ignore_errors=True)
            os.makedirs(ranks_dir)
            try:
                ranks = timed("ranks", phase_ranks, filenames, smi, ranks_dir)
            finally:
                shutil.rmtree(ranks_dir, ignore_errors=True)
            start_head_early("cluster")
            audit_dir = os.path.join(ROOT, "build", "audit")
            shutil.rmtree(audit_dir, ignore_errors=True)
            os.makedirs(audit_dir)
            try:
                audited = timed("audit", phase_audit, torch, filenames, NUM_ROWS, slices["dlrm"], audit_dir)
            finally:
                shutil.rmtree(audit_dir, ignore_errors=True)
            start_head_early("faults")
            cluster_dir = os.path.join(ROOT, "build", "cluster")
            shutil.rmtree(cluster_dir, ignore_errors=True)
            os.makedirs(cluster_dir)
            try:
                cluster = timed("cluster", phase_cluster, torch, filenames, slices["dlrm"], cluster_dir)
            finally:
                shutil.rmtree(cluster_dir, ignore_errors=True)
            start_head_early("telemetry")
            faults_dir = os.path.join(ROOT, "build", "faults")
            shutil.rmtree(faults_dir, ignore_errors=True)
            os.makedirs(faults_dir)
            try:
                faults = timed("faults", phase_faults, torch, filenames, cluster["single"], faults_dir)
            finally:
                shutil.rmtree(faults_dir, ignore_errors=True)
            start_head_early("obs")
            telemetry_dir = os.path.join(ROOT, "build", "telemetry")
            shutil.rmtree(telemetry_dir, ignore_errors=True)
            os.makedirs(telemetry_dir)
            try:
                telemetry = timed("telemetry", phase_telemetry, torch, filenames, cluster["single"], slices["dlrm"],
                                  telemetry_dir)
            finally:
                shutil.rmtree(telemetry_dir, ignore_errors=True)
            start_head_early("elastic")
            obs_dir = os.path.join(ROOT, "build", "obs")
            shutil.rmtree(obs_dir, ignore_errors=True)
            os.makedirs(obs_dir)
            try:
                obs = timed("obs", phase_obs, torch, filenames, cluster, obs_dir)
            finally:
                shutil.rmtree(obs_dir, ignore_errors=True)
            start_head_early("service")
            elastic_dir = os.path.join(ROOT, "build", "elastic")
            shutil.rmtree(elastic_dir, ignore_errors=True)
            os.makedirs(elastic_dir)
            try:
                elastic = timed("elastic", phase_elastic, torch, filenames, cluster, elastic_dir)
            finally:
                shutil.rmtree(elastic_dir, ignore_errors=True)
            service_dir = os.path.join(ROOT, "build", "service")
            shutil.rmtree(service_dir, ignore_errors=True)
            os.makedirs(service_dir)
            try:
                service = timed("service", phase_service, torch, filenames, cluster, service_dir)
            finally:
                shutil.rmtree(service_dir, ignore_errors=True)
            resume_dir = os.path.join(ROOT, "build", "resume")
            shutil.rmtree(resume_dir, ignore_errors=True)
            os.makedirs(resume_dir)
            try:
                resume = timed("resume", phase_resume, torch, resume_dir, smi, filenames)
            finally:
                shutil.rmtree(resume_dir, ignore_errors=True)
            pod_dir = os.path.join(ROOT, "build", "pod")
            shutil.rmtree(pod_dir, ignore_errors=True)
            os.makedirs(pod_dir)
            try:
                pod = timed("pod", phase_pod, torch, filenames, data_dir, smi, pod_dir)
            finally:
                shutil.rmtree(pod_dir, ignore_errors=True)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        plan_dir = os.path.join(ROOT, "build", "plan_data")
        shutil.rmtree(plan_dir, ignore_errors=True)
        try:
            plan = timed("plan", phase_plan, torch, plan_dir)
        finally:
            shutil.rmtree(plan_dir, ignore_errors=True)
        resident_dir = os.path.join(ROOT, "build", "resident_data")
        shutil.rmtree(resident_dir, ignore_errors=True)
        try:
            resident = timed("resident", phase_resident, torch, resident_dir, smi)
        finally:
            shutil.rmtree(resident_dir, ignore_errors=True)
        trials = [slices["dlrm"].pop("trial"), resident.pop("trial")]
        trials[1].trial = 1
        import ray_shuffling_data_loader_tpu_torch as port

        stats_dir = os.path.join(ROOT, "build", "stats")
        summary = port.process_stats(trials, stats_dir=stats_dir)
        log(trial_line("slice dlrm", trials[0]))
        log(f"[stats] wrote {', '.join(sorted(os.listdir(stats_dir)))} under build/stats/: {summary}")
        lm = timed("lm", phase_lm, torch)
        sp_dir = os.path.join(ROOT, "build", "sp")
        shutil.rmtree(sp_dir, ignore_errors=True)
        os.makedirs(sp_dir)
        try:
            sp = timed("sp", phase_sp, torch, sp_dir, smi)
        finally:
            shutil.rmtree(sp_dir, ignore_errors=True)
        parity = {
            label: phase_parity(torch, label, slices[label]["model"], slices[label]["batch"])
            for label in ("dlrm", "tabtransformer")
        }
        # Each kernel's launches on the path that runs it: the DLRM's bf16
        # steps (K1's tensor-core route), its fp32 parity forward (K1's
        # CUDA-core route), the CausalLM (the flash kernels' tensor-core
        # route) and the TabTransformer (their CUDA-core route); and on the
        # flash kernels' tensor-core route the sp runs' sums over their
        # ranks (launches_sp_ring, launches_sp_ulysses).
        for entry in kernels:
            kname = entry["name"]
            if kname.startswith("interaction"):
                counts = slices["dlrm"]["launches"] if kname.endswith("_mma") else parity["dlrm"][1]
            else:
                counts = (lm if kname.endswith("_mma") else slices["tabtransformer"])["launches"]
            entry["launches"] = (counts[kname] if kname.endswith("_mma")
                                 else counts[kname] - counts[f"{kname}_mma"])
            if kname.startswith("flash") and kname.endswith("_mma"):  # and over the ranks of each sp run
                for attention in SP_ATTENTIONS:
                    entry[f"launches_sp_{attention}"] = sp["train"][attention]["launches"][kname]
            if kname == "interaction_mma":  # and on every rank of the vocab-sharded run
                entry["launches_ranks_dp2_mp2"] = sum(
                    res["launches"]["interaction"]["mma_launches"] for res in ranks["dp2_mp2"]["ranks"])
                # and in the plan phase's six DLRM runs
                entry["launches_plan"] = plan["launches"]["interaction_mma"]
                # and in the audited DLRM run
                entry["launches_audit"] = audited["dlrm"]["launches"]["interaction_mma"]
                # and in the DLRM run on the two-host cluster
                entry["launches_cluster"] = cluster["launches"]["interaction_mma"]
                # and in the DLRM run recovered through the fault schedule
                entry["launches_faults"] = faults["launches"]["interaction_mma"]
                # and in the metered DLRM run of the metrics and trace planes
                entry["launches_telemetry"] = telemetry["metered"]["launches"]["interaction_mma"]
                # and in the DLRM run on two hosts with split spools under the
                # SLO engine, the relay and the obs server
                entry["launches_obs"] = obs["launches"]["interaction_mma"]
                # and in the DLRM run on two hosts under the elastic loop, a
                # store budget and a drain
                entry["launches_elastic"] = elastic["launches"]["interaction_mma"]
                # and in the two tenants' DLRM runs through the multi-job
                # service
                entry["launches_service"] = service["launches_service"]
                # and in the DLRM run over file:// URIs
                entry["launches_uri"] = uri["launches"]["interaction_mma"]
                # and on the four ranks of the pod trainer
                entry["launches_pod"] = pod["launches"]
    except Exception:
        traceback.print_exc()
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    finally:
        stop_early_heads()
        shutil.rmtree(HEAD_DIR, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; phase walls (s): "
        + ", ".join(f"{name} {secs:.1f}" for name, secs in WALLS.items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "device": smi,
                    "walls": WALLS,
                    "kernels": kernels,
                    "flash": flash,
                    "slices": {
                        label: {k: v for k, v in sl.items() if k not in ("model", "batch", "init_state")}
                        for label, sl in slices.items()
                    },
                    "lm": lm,
                    "sp": sp,
                    "native": host,
                    "lint": lint,
                    "delivery": delivery,
                    "ranks": ranks,
                    "plan": plan,
                    "resident": resident,
                    "resume": resume,
                    "audit": audited,
                    "cluster": cluster,
                    "faults": faults,
                    "telemetry": telemetry,
                    "obs": obs,
                    "elastic": elastic,
                    "service": service,
                    "uri": uri,
                    "pod": pod,
                    "parity_max_abs_diff": {label: err for label, (err, _) in parity.items()},
                },
                f, indent=1,
            )
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

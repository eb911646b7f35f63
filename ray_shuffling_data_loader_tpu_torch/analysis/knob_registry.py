"""The ``RSDL_*`` knobs: one :class:`Knob` per variable the packages read.

The names are the JAX package's registry's, one for one; the port reads
no variable of its own. :func:`..telemetry.runledger._knob_snapshot`
reads this table to record every knob a run had set, and
``tests/test_torch_port_imports.py`` holds every ``RSDL_*`` name the
port's modules read to it.

``scope``: ``public``, a deploy-time surface an operator may set;
``internal``, bench, test and harness plumbing. ``prefix=True`` declares
a family: every name that starts with ``name``. ``planned=True`` marks a
knob the plan compiler owns (:data:`..analysis.planner.TERM_KNOBS`):
under ``RSDL_PLAN=auto`` and unset, the cost model picks its value.

Data only; standard library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # flag | int | float | str | path | enum | spec | prefix
    default: str
    scope: str  # public | internal
    help: str = ""
    prefix: bool = False
    planned: bool = False  # owned by the plan compiler (RSDL_PLAN)


KNOBS: Tuple[Knob, ...] = (
    # -- runtime / store ----------------------------------------------------
    Knob("RSDL_RUNTIME_DIR", "path", "new session", "public",
         "join an existing session's runtime directory"),
    Knob("RSDL_SHM_DIR", "path", "/dev/shm", "public",
         "shared-memory store root"),
    Knob("RSDL_STORE_CAPACITY_BYTES", "int", "unset", "public",
         "absolute store budget before spill"),
    Knob("RSDL_STORE_CAPACITY_FRACTION", "float", "0.8", "public",
         "store budget as a fraction of shm"),
    Knob("RSDL_SPILL_DIR", "path", "disk tmp", "public",
         "where over-budget segments spill"),
    Knob("RSDL_ADVERTISE_HOST", "str", "auto", "public",
         "address other hosts dial for this host"),
    Knob("RSDL_CLUSTER_TOKEN", "str", "auto", "public",
         "cluster bearer token"),
    Knob("RSDL_SPAWN_READY_TIMEOUT_S", "float", "600", "public",
         "actor-spawn readiness deadline"),
    Knob("RSDL_DISABLE_LOCALITY", "flag", "off", "public",
         "turn off locality-aware scheduling"),
    Knob("RSDL_TCP_ZEROCOPY", "flag", "off", "public",
         "zero-copy cross-host fetch plane"),
    Knob("RSDL_TCP_STREAMS", "int", "1", "public",
         "striped connections per peer (zero-copy plane)"),
    Knob("RSDL_FETCH_WINDOW_DEPTH", "int", "4/8", "public",
         "window-pipelining depth", planned=True),
    Knob("RSDL_REDUCE_FETCH_OVERLAP", "enum", "auto", "public",
         "overlap reduce-side fetch with the gather"),
    # -- recovery / retry ---------------------------------------------------
    Knob("RSDL_CALL_RETRIES", "int", "3", "public",
         "actor-call retry budget (pre-send connection failures)"),
    Knob("RSDL_CALL_DEADLINE_S", "float", "60", "public",
         "per-actor-call deadline"),
    Knob("RSDL_CONNECT_MAX_BACKOFF_S", "float", "5", "public",
         "cap on the jittered connect backoff"),
    Knob("RSDL_STAGE_MAX_ATTEMPTS", "int", "3", "public",
         "driver-side bounded stage re-execution budget"),
    Knob("RSDL_PRODUCER_LIVENESS_S", "float", "2.0", "public",
         "producer-liveness poll slice for blocking queue reads"),
    # -- fault injection (chaos) -------------------------------------------
    Knob("RSDL_FAULTS", "spec", "off", "public",
         "fault-injection schedule site[/role]:kind:prob[@epoch][xN],..."),
    Knob("RSDL_FAULTS_SEED", "int", "0", "public",
         "determinism anchor for the fault schedule"),
    Knob("RSDL_FAULTS_DELAY_S", "float", "0.05", "public",
         "sleep for delay/stall fault kinds"),
    Knob("RSDL_FAULTS_WEDGE_S", "float", "30", "public",
         "sleep for the wedge fault kind"),
    # -- shuffle engine -----------------------------------------------------
    Knob("RSDL_INDEX_SHUFFLE", "enum", "auto", "public",
         "index-only steady-state schedule"),
    Knob("RSDL_HOST_PROBE", "enum", "on", "public",
         "once-per-process host bandwidth probe"),
    Knob("RSDL_DECODE_THREADS", "enum", "auto", "public",
         "Arrow per-read threads inside decode tasks"),
    Knob("RSDL_DECODE_ROWGROUPS", "enum", "off", "public",
         "row-group decode execution plan", planned=True),
    Knob("RSDL_DECODE_PUSHDOWN", "enum", "auto", "public",
         "column pushdown for decode", planned=True),
    Knob("RSDL_DECODE_CACHE_SHARED", "flag", "off", "public",
         "cross-epoch shared decode-cache tier"),
    Knob("RSDL_SHUFFLE_PLAN", "enum", "rowwise", "public",
         "seeded plan family (rowwise | block[:G])", planned=True),
    Knob("RSDL_SELECTIVE_READS", "enum", "off", "public",
         "RINAS-style selective schedule", planned=True),
    Knob("RSDL_DISABLE_NATIVE", "flag", "off", "public",
         "skip the C++ kernels"),
    Knob("RSDL_NATIVE_CACHE", "path", "repo dir", "public",
         "compiled kernel .so cache dir"),
    Knob("RSDL_NATIVE_THREADS", "int", "min(8, cores)", "public",
         "kernel thread count", planned=True),
    # -- self-tuning plan compiler ------------------------------------------
    Knob("RSDL_PLAN", "enum", "off", "public",
         "cost-based plan compiler (auto | off): plans the planned=True "
         "knobs from footer stats; env-set knobs stay pinned"),
    # -- staging / resident -------------------------------------------------
    Knob("RSDL_DEVICE_DIRECT", "enum", "auto", "public",
         "device-direct delivery kill switch"),
    Knob("RSDL_RESIDENT_BUDGET_GB", "float", "measured", "public",
         "HBM budget override for fits_device"),
    Knob("RSDL_TPU_HBM_GB", "float", "16", "public",
         "per-device HBM for plugins without memory_stats"),
    # -- kernels (ops) ------------------------------------------------------
    Knob("RSDL_FLASH_BWD", "enum", "pallas", "public",
         "flash-attention VJP route (pallas | xla)"),
    # -- telemetry: trace / metrics / audit ---------------------------------
    Knob("RSDL_TRACE", "flag", "off", "public",
         "tracing gate"),
    Knob("RSDL_TRACE_DIR", "path", "unset", "public",
         "cross-process trace spool dir"),
    Knob("RSDL_TRACE_BUFFER", "int", "200000", "public",
         "per-process span buffer bound"),
    Knob("RSDL_TRACE_OUT", "path", "unset", "public",
         "default --trace-out for bench.py"),
    Knob("RSDL_METRICS", "flag", "off", "public",
         "master metrics gate (events/stragglers/capacity ride it)"),
    Knob("RSDL_METRICS_DIR", "path", "$RSDL_RUNTIME_DIR/metrics", "public",
         "metrics spool override"),
    Knob("RSDL_METRICS_OUT", "path", "unset", "public",
         "default --metrics-out for bench.py"),
    Knob("RSDL_AUDIT", "flag", "off", "public",
         "exactly-once digest layer gate"),
    Knob("RSDL_AUDIT_DIR", "path", "unset", "public",
         "audit spool dir (shared fs on multi-host)"),
    Knob("RSDL_AUDIT_STRICT", "flag", "off", "public",
         "raise AuditError on digest mismatch"),
    Knob("RSDL_AUDIT_KEY", "str", "key", "public",
         "audit key column"),
    Knob("RSDL_AUDIT_SAMPLE", "int", "4096", "public",
         "sampled keys for shuffle-quality metrics"),
    Knob("RSDL_EVENTS_DIR", "path", "$RSDL_RUNTIME_DIR/events", "public",
         "structured event-log spool override"),
    # -- telemetry: obs endpoint / temporal / decision ----------------------
    Knob("RSDL_OBS_PORT", "int", "off", "public",
         "live observability endpoint port"),
    Knob("RSDL_OBS_HOST", "str", "127.0.0.1", "public",
         "obs endpoint bind host"),
    Knob("RSDL_OBS_STALE_S", "float", "unset", "public",
         "drop spool sources older than this from aggregation"),
    Knob("RSDL_TS", "flag", "off", "public",
         "force the timeseries sampler headless"),
    Knob("RSDL_TS_PERIOD_S", "float", "2", "public",
         "sampler tick period"),
    Knob("RSDL_TS_SAMPLES", "int", "900", "public",
         "timeseries ring capacity"),
    Knob("RSDL_SLO_RULES", "spec", "default pack", "public",
         "alert rules (inline JSON or a file path)"),
    Knob("RSDL_STRAGGLER_K", "float", "unset", "public",
         "straggler budget multiplier over the stage median"),
    Knob("RSDL_STRAGGLER_MIN_S", "float", "unset", "public",
         "straggler budget floor"),
    # -- elasticity ---------------------------------------------------------
    Knob("RSDL_ELASTIC", "enum", "off", "public",
         "elastic control loop gate"),
    Knob("RSDL_ELASTIC_PERIOD_S", "float", "RSDL_TS_PERIOD_S", "public",
         "control-loop tick period"),
    Knob("RSDL_ELASTIC_MIN_WORKERS", "int", "1", "public",
         "autoscaler lower bound"),
    Knob("RSDL_ELASTIC_MAX_WORKERS", "int", "2x cores", "public",
         "autoscaler upper bound"),
    Knob("RSDL_ELASTIC_UP_THRESHOLD", "float", "0.5", "public",
         "scale-up sole-active share threshold"),
    Knob("RSDL_ELASTIC_DOWN_THRESHOLD", "float", "0.1", "public",
         "scale-down sole-active share threshold"),
    Knob("RSDL_ELASTIC_COOLDOWN_S", "float", "30", "public",
         "minimum spacing between scale decisions"),
    Knob("RSDL_DRAIN_DEADLINE_S", "float", "30", "public",
         "bounded wait for a draining agent"),
    Knob("RSDL_EVICT_HIGH_WATERMARK", "float", "0.85", "public",
         "evictor hysteresis: start demoting above"),
    Knob("RSDL_EVICT_LOW_WATERMARK", "float", "0.6", "public",
         "evictor hysteresis: stop below"),
    Knob("RSDL_EVICT_COOLDOWN_S", "float", "5", "public",
         "minimum spacing between eviction passes"),
    Knob("RSDL_EVICT_DROP_AGE_S", "float", "300", "public",
         "spill-tier drop age during a pressure pass"),
    # -- multi-job service --------------------------------------------------
    Knob("RSDL_SERVICE", "enum", "off", "public",
         "multi-tenant shuffle-service plane gate (auto | off)"),
    Knob("RSDL_JOB_NAME", "str", "job", "public",
         "stable name for auto-registered service jobs"),
    Knob("RSDL_JOB_ID", "str", "unset", "public",
         "ambient job id for processes joining a job (trainer ranks)"),
    Knob("RSDL_JOB_WEIGHT", "float", "1.0", "public",
         "fair-share scheduling weight for this process's jobs"),
    Knob("RSDL_SERVICE_ADMIT_FRAC", "float", "0.85", "public",
         "shm-used fraction above which new epoch windows wait"),
    Knob("RSDL_SERVICE_ADMIT_TIMEOUT_S", "float", "30", "public",
         "bounded admission wait before a window proceeds anyway"),
    Knob("RSDL_RUN_LEDGER", "path", "off", "public",
         "durable run-ledger NDJSON (1/on/true/auto = "
         "<runtime_dir>/runs/ledger.ndjson, anything else = explicit "
         "path)"),
    # -- suspend / resume ---------------------------------------------------
    Knob("RSDL_JOURNAL", "path", "off", "public",
         "driver write-ahead journal dir"),
    Knob("RSDL_JOURNAL_SYNC", "flag", "on", "public",
         "fsync-per-append toggle"),
    Knob("RSDL_RESUME", "enum", "off", "public",
         "resume mode (auto | redeliver)"),
    # -- tests / tools (documented) -----------------------------------------
    Knob("RSDL_TPU_TESTS", "flag", "off", "public",
         "enable the TPU-gated test files"),
    # -- continuous profiling plane -----------------------------------------
    Knob("RSDL_PROFILE", "flag", "off", "public",
         "cluster-wide wall-clock sampling profiler (every RSDL "
         "process runs a sampler daemon thread)"),
    Knob("RSDL_PROFILE_HZ", "float", "67", "public",
         "sampling rate, clamped to [1, 500]; the off-round default "
         "avoids phase-locking with 1 s periodic work"),
    Knob("RSDL_PROFILE_DIR", "path", "<runtime_dir>/profiles", "public",
         "profile spool override (per-process profile-*.json "
         "aggregates; was the jax.profiler wrap knob, now "
         "RSDL_BENCH_XPROF_DIR)"),
    Knob("RSDL_PROFILE_TOP_N", "int", "20", "public",
         "default row count for /profile and rsdl_prof top tables"),
    # -- spool-federation plane ---------------------------------------------
    Knob("RSDL_RELAY", "enum", "off", "public",
         "cross-host telemetry federation (auto | off): non-head hosts "
         "ship spool deltas to a driver-side sink over the authed "
         "transport"),
    Knob("RSDL_RELAY_PERIOD_S", "float", "0.5", "public",
         "shipper period between ships (flush barriers kick it sooner)"),
    Knob("RSDL_RELAY_MAX_BATCH_BYTES", "int", "4194304", "public",
         "per-ship payload cap; the rest goes next cycle"),
    Knob("RSDL_RELAY_MAX_LAG_BYTES", "int", "67108864", "public",
         "per-file backlog bound — past it the shipper drops forward "
         "to a line boundary and counts relay.dropped_bytes_total"),
    Knob("RSDL_STRESS_SEEDS", "int", "3", "internal",
         "seeds per stress-soak scenario"),
    Knob("RSDL_DRYRUN_MP", "enum", "on", "internal",
         "dryrun_multichip 2-process leg toggle"),
    # -- internal families (bench / harness plumbing) -----------------------
    Knob("RSDL_BENCH_", "prefix", "-", "internal",
         "bench.py workload/capture knobs (documented rows in TUNING.md "
         "carry no compatibility promise)", prefix=True),
    Knob("RSDL_SWEEP_", "prefix", "-", "internal",
         "trainer-sweep workload shape (read by tools/*.sh)", prefix=True),
    Knob("RSDL_T_", "prefix", "-", "internal",
         "2-process pod test harness plumbing", prefix=True),
    Knob("RSDL_MP_", "prefix", "-", "internal",
         "dryrun_multichip 2-process leg plumbing", prefix=True),
    Knob("RSDL_TEST_", "prefix", "-", "internal",
         "TPU-gated test harness plumbing (repo/tmp paths)", prefix=True),
    Knob("RSDL_PROBE", "str", "-", "internal",
         "bench backend-probe stdout marker (not an env read)"),
    Knob("RSDL_CI_TIER", "enum", "all", "internal",
         "run_ci_tests.sh tier selection (shell-read)"),
)


class KnobRegistry:
    def __init__(self, knobs: Tuple[Knob, ...]):
        self.knobs: Tuple[Knob, ...] = knobs
        self._exact = {k.name: k for k in knobs if not k.prefix}
        self._prefixes: List[Knob] = [k for k in knobs if k.prefix]

    def lookup(self, name: str, is_prefix: bool = False) -> Optional[Knob]:
        """Resolve a harvested read. ``is_prefix`` marks an f-string
        read whose literal head is ``name`` — it matches a prefix entry
        covering (or covered by) that head."""
        if not is_prefix:
            k = self._exact.get(name)
            if k is not None:
                return k
        for p in self._prefixes:
            if name.startswith(p.name):
                return p
            if is_prefix and p.name.startswith(name):
                return p
        return None


REGISTRY = KnobRegistry(KNOBS)



def registry_for(project) -> KnobRegistry:
    """The registry to lint ``project`` against: the one registry, for
    the repo and for every fixture tree alike."""
    return REGISTRY

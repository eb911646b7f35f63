"""The elastic control plane: an autoscaler, a graceful drain and a tiered
evictor, on the session owner.

The decision planes say where the bottleneck is (the critical path's
sole-active shares), who is wedged (the straggler view) and whose bytes lie
where (the capacity ledger); this module acts on those readings with three
actuators:

* **Autoscaler** (:meth:`ElasticController.autoscale_once`): when the live
  critical path lands on a shuffle stage with a sole-active share at or
  above ``RSDL_ELASTIC_UP_THRESHOLD`` (or a worker is wedged), add
  capacity: a worker of the :class:`~.tasks.WorkerPool` on one host, a new
  :class:`~.cluster.HostAgent` admitted with ``ClusterScheduler.add_agent``
  in a cluster. When the shuffle's stages fall to
  ``RSDL_ELASTIC_DOWN_THRESHOLD``, shed what this controller added, through
  the drain, never a kill.
* **Graceful drain** (:meth:`ElasticController.drain_host`):
  ``retire_agent`` stops dispatch to the host, the controller waits out its
  tasks under ``RSDL_DRAIN_DEADLINE_S``, copies the host's live segments
  into this host's store (ledger ``transition`` ops), then removes the agent
  and unregisters the host. A blown deadline, a crash mid-drain or a failed
  hand-over falls back to the fault plane's ``_drop_agent``: lineage re-makes
  what the host held.
* **Tiered evictor** (:meth:`ElasticController.evict_once`): under pressure
  on the store's budget (``RSDL_STORE_CAPACITY_BYTES``; the high and low
  watermarks ``RSDL_EVICT_HIGH_WATERMARK`` and ``_LOW_WATERMARK`` of the
  ledger's shm residency), drop the cold shared decode-cache segments, then
  demote cold epochs' segments to the spill directory, where they stay
  readable, down to the low watermark; and drop spilled segments untouched
  for ``RSDL_EVICT_DROP_AGE_S``, which lineage re-makes at their next read.
  The epochs still in flight are fenced (``shuffle.protected_epochs()``),
  and a segment of no known epoch is never touched. A delivered batch
  (``shuffle.delivered_ids()``) may be demoted but is never dropped: the
  fence ends at an epoch's delivery, its batches may still be queued, and
  no lineage re-makes one (the JAX package drops it).

Lifecycle: the session owner's start-up (``runtime._start_planes``) calls
:func:`maybe_start` when ``RSDL_ELASTIC`` is ``auto`` or ``on`` and metrics
are on (the loop's inputs are the metrics plane's folds); the loop ticks
every ``RSDL_ELASTIC_PERIOD_S`` (default the time series' period). With
``RSDL_ELASTIC`` unset this module is never imported, no thread runs and no
``transition`` record is written.

Surfacing: ``scale.*`` and ``evict.*`` events, the ``elastic.*`` counters and
gauges (``elastic.shm_headroom_frac`` and ``elastic.drain_age_seconds`` feed
the SLO pack's ``headroom_low`` and ``drain_stuck``), the cluster's
membership section on ``/status``, and :func:`summary`.

Names, events, counters, gauges and knobs are the JAX package's. Standard
library only.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch import telemetry
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

ENV_ELASTIC = "RSDL_ELASTIC"
ENV_PERIOD_S = "RSDL_ELASTIC_PERIOD_S"
ENV_MIN_WORKERS = "RSDL_ELASTIC_MIN_WORKERS"
ENV_MAX_WORKERS = "RSDL_ELASTIC_MAX_WORKERS"
ENV_UP_THRESHOLD = "RSDL_ELASTIC_UP_THRESHOLD"
ENV_DOWN_THRESHOLD = "RSDL_ELASTIC_DOWN_THRESHOLD"
ENV_COOLDOWN_S = "RSDL_ELASTIC_COOLDOWN_S"
ENV_DRAIN_DEADLINE_S = "RSDL_DRAIN_DEADLINE_S"
ENV_EVICT_HIGH = "RSDL_EVICT_HIGH_WATERMARK"
ENV_EVICT_LOW = "RSDL_EVICT_LOW_WATERMARK"
ENV_EVICT_COOLDOWN_S = "RSDL_EVICT_COOLDOWN_S"
ENV_EVICT_DROP_AGE_S = "RSDL_EVICT_DROP_AGE_S"

# The live verdict's stages that make the shuffle the bottleneck (the
# critical path's stages less the consumer's).
SHUFFLE_STAGES = ("map", "plan", "reduce", "gather-reduce", "selective-reduce")

_UNKNOWN_EPOCH = "-"
_SHUFFLE = "ray_shuffling_data_loader_tpu_torch.shuffle"


def mode() -> str:
    return os.environ.get(ENV_ELASTIC, "").strip().lower()


def enabled() -> bool:
    """Is the plane asked for (``auto``, ``on``, ``1``)? The session's
    start-up reads the same variable before it imports this module."""
    return mode() not in ("", "off", "0", "false")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ElasticController:
    """One controller: the policy's knobs and the three actuators. Made by
    :func:`start` (the loop) or directly by an operator or a test."""

    def __init__(self, ctx=None):
        if ctx is None:
            from ray_shuffling_data_loader_tpu_torch import runtime

            ctx = runtime.get_context()
        self._ctx = ctx
        self.min_workers = max(1, int(_env_float(ENV_MIN_WORKERS, 1)))
        self.max_workers = max(self.min_workers, int(_env_float(ENV_MAX_WORKERS, 2 * (os.cpu_count() or 1))))
        self.up_threshold = _env_float(ENV_UP_THRESHOLD, 0.5)
        self.down_threshold = _env_float(ENV_DOWN_THRESHOLD, 0.1)
        self.cooldown_s = _env_float(ENV_COOLDOWN_S, 30.0)
        self.drain_deadline_s = _env_float(ENV_DRAIN_DEADLINE_S, 30.0)
        self.evict_high = _env_float(ENV_EVICT_HIGH, 0.85)
        self.evict_low = _env_float(ENV_EVICT_LOW, 0.6)
        self.evict_cooldown_s = _env_float(ENV_EVICT_COOLDOWN_S, 5.0)
        self.drop_age_s = _env_float(ENV_EVICT_DROP_AGE_S, 300.0)
        self._lock = threading.Lock()
        self._last_scale_ts = float("-inf")
        self._last_evict_ts = float("-inf")
        # The agents THIS controller added, the only ones a scale-down may
        # drain: the hosts the cluster started with are the operator's.
        self._added_agents: List[Tuple[str, Any]] = []  # (host_id, handle)
        self._drain_started: Dict[Tuple, float] = {}  # address -> monotonic start
        self.scale_events = 0
        self.evicted_bytes = 0
        self.drains = 0

    # -- the signals ------------------------------------------------------------

    @staticmethod
    def _from_shuffle(read, default):
        """``read(shuffle)`` through ``sys.modules``, else ``default``: a
        controller in a process that never shuffles imports no shuffle."""
        shuffle_mod = sys.modules.get(_SHUFFLE)
        if shuffle_mod is None:
            return default
        try:
            return read(shuffle_mod)
        except Exception:
            return default

    def _protected_epochs(self) -> set:
        """The fence: the epochs in flight."""
        return self._from_shuffle(lambda m: {int(e) for e in m.protected_epochs()}, set())

    def _delivered(self) -> set:
        """The trial's delivered batches, which the drop rungs never take: a
        consumer may not have read one yet, and no lineage re-makes it."""
        return self._from_shuffle(lambda m: m.delivered_ids(), set())

    def _trial_in_flight(self) -> bool:
        return self._from_shuffle(lambda m: bool(m.live_status().get("running")), False)

    def _shm_frac(self, view: Dict[str, Any]) -> Optional[float]:
        """The used share of the shm budget: of this controller's store's
        own budget where it has one (the view knows a budget only with a
        session live in this process), else the view's."""
        budget = getattr(self._ctx.store, "capacity_bytes", None)
        if budget:
            return self._shm_resident(view) / budget
        frac = view.get("shm_used_frac")
        return None if frac is None else float(frac)

    @staticmethod
    def _shm_resident(view: Dict[str, Any]) -> int:
        """Bytes on shm (the shm tier and the cache tier), by the capacity
        ledger's one definition."""
        from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

        return capacity.shm_resident_bytes(view.get("totals", {}))

    def _shm_budget(self, view: Dict[str, Any]) -> Optional[int]:
        budget = getattr(self._ctx.store, "capacity_bytes", None)
        if budget:
            return int(budget)
        budget = (view.get("host") or {}).get("capacity_bytes")
        return int(budget) if budget else None

    def publish_gauges(self, now: Optional[float] = None) -> None:
        """The gauges the SLO rules read, each tick: ``elastic.shm_headroom_frac``
        (1 less the used share of the budget; ``headroom_low``),
        ``elastic.drain_age_seconds`` (the oldest drain's age, 0 with none;
        ``drain_stuck``), ``elastic.workers`` and ``elastic.draining_agents``.
        Never raises."""
        if not _metrics.enabled():
            return
        now = time.monotonic() if now is None else now
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

            frac = self._shm_frac(capacity.view())
            if frac is not None:
                _metrics.registry.gauge("elastic.shm_headroom_frac").set(max(0.0, 1.0 - float(frac)))
        except Exception:
            pass
        self._publish_drain_gauges(now)
        try:
            _metrics.registry.gauge("elastic.workers").set(float(self._sched_width()))
        except Exception:
            pass

    def _publish_drain_gauges(self, now: Optional[float] = None) -> None:
        """The drain's gauges alone: cheap enough for the drain's poll (the
        full :meth:`publish_gauges` folds the ledger)."""
        if not _metrics.enabled():
            return
        now = time.monotonic() if now is None else now
        try:
            with self._lock:
                started = list(self._drain_started.values())
            _metrics.registry.gauge("elastic.drain_age_seconds").set(max((now - t for t in started), default=0.0))
            _metrics.registry.gauge("elastic.draining_agents").set(len(started))
        except Exception:
            pass

    # -- the autoscaler -----------------------------------------------------------

    def autoscale_once(self, now: Optional[float] = None) -> Optional[str]:
        """One decision from the live verdicts: ``"up"``, ``"down"`` or None.
        Acts only while a trial runs (between trials there is no critical
        path) and once a cooldown, so that one slow epoch cannot thrash the
        membership."""
        now = time.monotonic() if now is None else now
        if not self._trial_in_flight():
            return None
        with self._lock:
            if now - self._last_scale_ts < self.cooldown_s:
                return None
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import critical

            current = critical.analyze().get("current") or {}
        except Exception:
            return None
        stage = current.get("critical_path")
        shares = current.get("sole_share") or {}
        shuffle_share = sum(float(shares.get(s, 0.0)) for s in SHUFFLE_STAGES)
        wedged = 0
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

            wedged = len(stragglers.analyze().get("wedged") or [])
        except Exception:
            pass
        if (stage in SHUFFLE_STAGES and float(shares.get(stage, 0.0)) >= self.up_threshold) or wedged:
            if self._scale_up(reason="wedged-worker" if wedged else f"critical:{stage}",
                              share=round(float(shares.get(stage, 0.0)), 4)):
                with self._lock:
                    self._last_scale_ts = now
                return "up"
            return None
        if shuffle_share <= self.down_threshold and not wedged:
            if self._scale_down(share=round(shuffle_share, 4)):
                with self._lock:
                    self._last_scale_ts = now
                return "down"
        return None

    def _sched_width(self) -> int:
        """The scheduler's width without side effects: a context whose pool
        has not started yet reports its configured size (reading
        ``scheduler`` would start the pool to count it)."""
        ctx = self._ctx
        if getattr(ctx, "cluster", None) is None and hasattr(ctx, "_pool") and ctx._pool is None:
            return int(getattr(ctx, "num_workers", 0) or 0)
        return int(getattr(ctx.scheduler, "width", 0) or 0)

    def _workers_now(self) -> int:
        return self._sched_width()

    def _scale_up(self, reason: str, **fields) -> bool:
        sched = self._ctx.scheduler
        if self._workers_now() >= self.max_workers:
            return False
        if hasattr(sched, "add_workers"):  # a WorkerPool
            before = sched.num_workers
            after = sched.add_workers(1)
            if after <= before:
                return False
            detail = {"workers": after}
        elif hasattr(sched, "add_agent"):  # a ClusterScheduler
            detail = self._spawn_scale_agent()
            if detail is None:
                return False
        else:
            return False
        with self._lock:
            self.scale_events += 1
        _metrics.safe_inc("elastic.scale_events_total", direction="up")
        telemetry.emit_event("scale.up", _flush=True, reason=reason, **detail, **fields)
        return True

    def _spawn_scale_agent(self) -> Optional[Dict[str, Any]]:
        """A cluster's scale-up: a new HostAgent of one worker on this host,
        registered as a host of its own (so that the scheduler's rebuilds
        keep it) and admitted to the rotation. Its workers join this
        session; the session's end stops it."""
        from .actor import spawn_actor
        from .cluster import HostAgent

        ctx = self._ctx
        cluster = getattr(ctx, "cluster", None)
        advertise = getattr(cluster, "advertise_host", None) if cluster is not None else None
        try:
            # On TCP at the advertised address (as start_host_services
            # binds an agent): its address is published cluster-wide.
            agent = spawn_actor(HostAgent, ctx.runtime_dir, 1, advertise, runtime_dir=ctx.runtime_dir,
                                host=advertise, daemon=False)
        except Exception:
            return None
        owned = getattr(ctx, "_owned_actors", None)
        if owned is not None:
            owned.append(agent)
        host_id = f"elastic-{agent.pid}:{ctx.session}"
        if cluster is not None and hasattr(cluster, "registry"):
            try:
                cluster.registry.call("register_host", host_id, list(agent.address),
                                      list(cluster.store_server.address), 1)
            except Exception:
                pass
        sched = ctx.scheduler
        if hasattr(sched, "add_agent"):
            sched.add_agent(agent, num_workers=1)
        with self._lock:
            self._added_agents.append((host_id, agent))
        return {"agent": str(agent.address), "host_id": host_id}

    def _scale_down(self, **fields) -> bool:
        sched = self._ctx.scheduler
        if hasattr(sched, "retire_workers"):  # a WorkerPool
            if sched.num_workers <= self.min_workers:
                return False
            retired = sched.retire_workers(1)
            with self._lock:
                self.scale_events += 1
            _metrics.safe_inc("elastic.scale_events_total", direction="down")
            telemetry.emit_event("scale.down", _flush=True, workers=sched.num_workers, retired_pids=retired, **fields)
            return True
        with self._lock:
            added = list(self._added_agents)
        if not added:
            return False  # the policy never drains a host the cluster started with
        host_id, agent = added[-1]
        outcome = self.drain_host(agent, host_id=host_id)
        if outcome is None:
            return False
        with self._lock:
            self.scale_events += 1
            self._added_agents = [(h, a) for h, a in self._added_agents if h != host_id]
        _metrics.safe_inc("elastic.scale_events_total", direction="down")
        telemetry.emit_event("scale.down", _flush=True, agent=str(agent.address), host_id=host_id, outcome=outcome,
                             **fields)
        return True

    # -- the graceful drain ---------------------------------------------------------

    def drain_host(self, agent_or_address, host_id: Optional[str] = None, deadline_s: Optional[float] = None,
                   store_handle=None) -> Optional[str]:
        """Take one host agent out of the cluster, as planned.

        ``retire_agent`` (no new tasks), then wait for its tasks in flight
        under ``deadline_s``, pinging the agent each poll (a crash is seen,
        not waited out), then copy its live segments into this host's store
        (ledger ``transition`` ops), then ``remove_agent`` and the registry's
        ``unregister_host`` (which sweeps its actor names). A blown deadline,
        a crash or a failed copy falls back to ``_drop_agent``: the failover
        and lineage take over what the plan could not hand over.

        Returns ``"drained"``, ``"backstop"``, or None (no cluster scheduler,
        or an agent it does not know)."""
        sched = self._ctx.scheduler
        if not hasattr(sched, "retire_agent"):
            return None
        agent = sched.retire_agent(agent_or_address)
        if agent is None:
            return None
        deadline_s = self.drain_deadline_s if deadline_s is None else deadline_s
        address = tuple(agent.address)
        started = time.monotonic()
        with self._lock:
            self.drains += 1
            self._drain_started[address] = started
        _metrics.safe_inc("elastic.drains_total")
        telemetry.emit_event("scale.drain", _flush=True, agent=str(agent.address), host_id=host_id,
                             deadline_s=deadline_s)
        alive = True
        try:
            deadline = started + max(0.0, deadline_s)
            while sched.in_flight_on(address) > 0:
                self._publish_drain_gauges()
                if time.monotonic() >= deadline:
                    break
                if not agent.ping(timeout=2.0):
                    alive = False  # crashed mid-drain: nothing to wait for
                    break
                time.sleep(0.05)
            drained = alive and sched.in_flight_on(address) == 0
            if drained:
                try:
                    self._rehome_segments(agent, store_handle=store_handle)
                except Exception:
                    logging.getLogger(__name__).warning("drain: re-homing %s's segments failed", address,
                                                        exc_info=True)
                    drained = False
            if drained:
                sched.remove_agent(address)
                self._retire_store(address)
                self._unregister_host(host_id, address)
                telemetry.emit_event("scale.drain_done", _flush=True, agent=str(agent.address), host_id=host_id,
                                     waited_s=round(time.monotonic() - started, 3))
                return "drained"
            # The backstop: _drop_agent fires agent.evicted and the
            # scheduler's on_agent_dead; tasks fail over, and lost segments
            # are re-made from lineage.
            _metrics.safe_inc("elastic.drain_backstops_total")
            telemetry.emit_event("scale.drain_backstop", _flush=True, agent=str(agent.address), host_id=host_id,
                                 agent_alive=alive, in_flight=sched.in_flight_on(address))
            sched._drop_agent(agent)
            self._unregister_host(host_id, address)
            return "backstop"
        finally:
            with self._lock:
                self._drain_started.pop(address, None)
            self.publish_gauges()

    def _host_record(self, address) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
        """``(host_id, record)`` of the registry's host whose agent is at
        ``address``; ``(None, None)`` outside a cluster or when none is."""
        cluster = getattr(self._ctx, "cluster", None)
        if cluster is None or not hasattr(cluster, "registry"):
            return None, None
        for hid, info in cluster.registry.call("hosts").items():
            if tuple(info.get("agent") or ()) == tuple(address):
                return hid, info
        return None, None

    def _retire_store(self, address) -> None:
        """After a clean hand-over, this host's client stops calling the
        drained host's store server: its live segments are here now."""
        cluster = getattr(self._ctx, "cluster", None)
        try:
            _, info = self._host_record(address)
            if info is not None and hasattr(cluster, "retire_store"):
                cluster.retire_store(tuple(info["store"]))
        except Exception:
            pass

    def _unregister_host(self, host_id: Optional[str], address) -> None:
        cluster = getattr(self._ctx, "cluster", None)
        if cluster is None or not hasattr(cluster, "registry"):
            return
        try:
            hosts = cluster.registry.call("hosts")
        except Exception:
            return
        for hid, info in hosts.items():
            if hid == host_id or tuple(info.get("agent") or ()) == tuple(address):
                try:
                    cluster.registry.call_oneway("unregister_host", hid)
                except Exception:
                    pass

    def _rehome_segments(self, agent, store_handle=None) -> int:
        """Copy the draining host's live segments into this host's store,
        under their own ids: readers here resolve them without a fetch, and
        a reader elsewhere that still dials the gone owner falls back to
        lineage. The host's segments carry its session's prefix (its host
        id ends in its session), which this store adopts, so that its
        budget and ``store_stats`` count them; a foreign ref's ``free``
        unlinks its copy here. The names of one
        segment (its windows' hardlinks) are copied once and linked again
        here; a name already here moves nothing. Each copy notes one ledger
        ``transition`` in the tier it lands on. A segment freed while the
        copy runs is skipped, or its copied names unlinked. Returns the
        bytes copied."""
        store = self._ctx.store
        sessions = [store.session]
        try:
            host_id, info = self._host_record(agent.address)
        except Exception:
            host_id, info = None, None
        if info is not None:
            if store_handle is None:
                store_handle = self._ctx.cluster._peer_store(tuple(info["store"]))
            sessions.append(host_id.rpartition(":")[2])
        if store_handle is None:
            return 0
        moved = 0
        for session in dict.fromkeys(s for s in sessions if s):
            try:
                links = store_handle.call("list_segment_links", f"{session}-")
            except Exception:
                continue
            if links and session != store.session:
                store.adopt_session(session)
            segments: Dict[Any, List[str]] = {}
            for name, _, inode in links:
                segments.setdefault(inode, []).append(name)
            for names in segments.values():
                names = [n for n in names if store._find_segment(n) is None]
                if names:
                    moved += self._rehome_one(store, store_handle, names)
        if moved:
            telemetry.emit_event("scale.rehomed", nbytes=moved, agent=str(agent.address))
        return moved

    def _rehome_one(self, store, store_handle, names: List[str]) -> int:
        """Copy one segment, named ``names`` at its owner, into ``store``;
        returns its bytes, 0 when its owner freed it meanwhile."""
        data = None
        for name in names:
            try:
                data = store_handle.call("fetch", name, None)
                break
            except FileNotFoundError:
                continue  # this link was freed since the listing
        if data is None:
            return 0
        directory = store._placement_dir(len(data))
        path = os.path.join(directory, names[0])
        tmp = f"{path}.rehome-{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.rename(tmp, path)
            for name in names[1:]:
                try:
                    os.link(path, os.path.join(directory, name))
                except FileExistsError:
                    pass
        except BaseException:
            for p in (tmp, *(os.path.join(directory, n) for n in names)):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
            raise
        # A name its owner freed while it was copied has no reader left.
        live = []
        for name in names:
            if store_handle.call("exists", name):
                live.append(name)
            else:
                try:
                    os.unlink(os.path.join(directory, name))
                except FileNotFoundError:
                    pass
        if not live:
            return 0
        self._ledger_transition(live[0], len(data), store.tier_of(path))
        return len(data)

    @staticmethod
    def _ledger_transition(object_id: str, nbytes: int, tier: str) -> None:
        if not _metrics.enabled():
            return
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

            capacity.note("transition", object_id, nbytes=nbytes, tier=tier)
        except Exception:
            pass

    # -- the tiered evictor --------------------------------------------------------

    @staticmethod
    def _last_touch(seg: Dict[str, Any]) -> float:
        return float(seg.get("last_touch") or seg["ts"])

    def _candidates(self, tier: str) -> List[Dict[str, Any]]:
        """The ledger's live segments on ``tier`` that may be evicted: of a
        known epoch (an unknown one cannot be proven cold) outside the
        fence, and on the cache tier under ``RSDL_SERVICE`` none that a live
        job claims.

        Ordered by last access: the epoch whose segments were read least
        recently (the ledger's ``touch`` ops over every tier) first, then
        within it the least recently touched segment, so that an old epoch
        a reader is still reading stays."""
        from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

        protected = self._protected_epochs()
        claimed: set = set()
        if tier == "cache" and os.environ.get("RSDL_SERVICE"):
            # The multi-job service's claims: a segment a live job reads is
            # in use across jobs.
            try:
                from ray_shuffling_data_loader_tpu_torch.runtime.service import claimed_cache_ids

                claimed = claimed_cache_ids()
            except Exception:
                claimed = set()
        live = capacity.live_segments()
        epoch_touch: Dict[str, float] = {}
        for seg in live:
            key = seg["epoch"]
            epoch_touch[key] = max(epoch_touch.get(key, 0.0), self._last_touch(seg))
        out = []
        for seg in live:
            if seg["tier"] != tier or seg["epoch"] == _UNKNOWN_EPOCH:
                continue
            try:
                epoch = int(seg["epoch"])
            except (TypeError, ValueError):
                continue
            if epoch in protected:
                continue
            if claimed and (seg["id"] in claimed or any(i in claimed for i in (seg["ids"] or []))):
                continue
            out.append(seg)
        out.sort(key=lambda s: (epoch_touch.get(s["epoch"], 0.0), int(s["epoch"]), self._last_touch(s), s["ts"]))
        return out

    def evict_once(self, now: Optional[float] = None, force: bool = False, force_drop: bool = False) -> Dict[str, int]:
        """One pass. Under pressure (the used share at or above the high
        watermark, past the cooldown; or ``force``): drop cold cache-tier
        segments, then demote cold epochs' shm segments, coldest first,
        until the residency is under the low watermark; then drop spilled
        segments untouched for the drop age (``force_drop``: whatever their
        age). Neither drop rung takes a delivered batch. Returns the pass's
        counts, which also add to :meth:`summary`."""
        now = time.time() if now is None else float(now)
        stats = {"demoted": 0, "demoted_bytes": 0, "dropped": 0, "dropped_bytes": 0}
        if not _metrics.enabled():
            return stats
        from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

        view = capacity.view(now=now)
        frac = self._shm_frac(view)
        pressured = frac is not None and float(frac) >= self.evict_high
        mono = time.monotonic()
        with self._lock:
            cooled = mono - self._last_evict_ts >= self.evict_cooldown_s
        if not (force or force_drop) and not (pressured and cooled):
            self.publish_gauges()
            return stats
        with self._lock:
            self._last_evict_ts = mono
        store = self._ctx.store
        budget = self._shm_budget(view)
        resident = self._shm_resident(view)
        target = self.evict_low * budget if budget else None
        demoted_epochs: set = set()
        dropped_epochs: set = set()
        delivered = self._delivered()

        def droppable(seg) -> bool:
            return not delivered or not (delivered & {seg["id"], *(seg["ids"] or [])})

        if force or pressured:
            # The first rung: the shared decode cache's segments, the
            # cheapest bytes to lose (lineage decodes them again from
            # Parquet at the next claim).
            for seg in self._candidates("cache"):
                if not force and target is not None and resident <= target:
                    break
                if not droppable(seg):
                    continue
                freed = store.drop_segments(seg["ids"] or [seg["id"]])
                if freed:
                    stats["dropped"] += 1
                    stats["dropped_bytes"] += freed
                    resident -= freed
                    dropped_epochs.add(seg["epoch"])
            for seg in self._candidates("shm"):
                if not force and target is not None and resident <= target:
                    break
                moved = store.demote(seg["ids"] or [seg["id"]])
                if moved:
                    stats["demoted"] += 1
                    stats["demoted_bytes"] += moved
                    resident -= moved
                    demoted_epochs.add(seg["epoch"])
        for seg in self._candidates("spill"):
            # The age rung keys on the last access: a spilled segment read
            # lately is in use.
            if (not force_drop and now - self._last_touch(seg) < self.drop_age_s) or not droppable(seg):
                continue
            freed = store.drop_segments(seg["ids"] or [seg["id"]])
            if freed:
                stats["dropped"] += 1
                stats["dropped_bytes"] += freed
                dropped_epochs.add(seg["epoch"])
        with self._lock:
            self.evicted_bytes += stats["demoted_bytes"] + stats["dropped_bytes"]
        if stats["demoted"]:
            _metrics.safe_inc("elastic.evicted_bytes_total", float(stats["demoted_bytes"]), action="demote")
            telemetry.emit_event("evict.demote", _flush=True, segments=stats["demoted"],
                                 nbytes=stats["demoted_bytes"], epochs=sorted(demoted_epochs))
        if stats["dropped"]:
            _metrics.safe_inc("elastic.evicted_bytes_total", float(stats["dropped_bytes"]), action="drop")
            telemetry.emit_event("evict.drop", _flush=True, segments=stats["dropped"],
                                 nbytes=stats["dropped_bytes"], epochs=sorted(dropped_epochs))
        self.publish_gauges()
        return stats

    # -- the loop ---------------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """One turn of the loop: the gauges, the autoscaler, the evictor.
        Never raises."""
        for step in (self.publish_gauges, self.autoscale_once):
            try:
                step()
            except Exception:
                pass
        try:
            self.evict_once(now=now)
        except Exception:
            pass

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"scale_events": self.scale_events, "evicted_gb": round(self.evicted_bytes / 2**30, 6),
                    "drains": self.drains}


# -- the module's loop (the session's start-up brings it up) ----------------------

_lock = threading.Lock()
_controller: Optional[ElasticController] = None
_thread: Optional[threading.Thread] = None
_stop_event: Optional[threading.Event] = None


def controller() -> Optional[ElasticController]:
    return _controller


def period_s() -> float:
    """The loop's period: ``RSDL_ELASTIC_PERIOD_S`` (at least 0.1 s), else
    the time series' period, so that readings and actions share a clock."""
    env = os.environ.get(ENV_PERIOD_S, "").strip()
    if env:
        try:
            return max(0.1, float(env))
        except ValueError:
            pass
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import timeseries

        return timeseries.period_s()
    except Exception:
        return 2.0


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def start(ctx=None, period: Optional[float] = None) -> None:
    """Start the loop (once; the session owner's, like the obs server and
    the sampler). With metrics off, nothing."""
    global _controller, _thread, _stop_event
    if not _metrics.enabled():
        return
    interval = period_s() if period is None else max(0.1, float(period))
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _controller = ElasticController(ctx)
        stop_event = threading.Event()
        _stop_event = stop_event
        ctl = _controller

        def _loop():
            while not stop_event.wait(interval):
                ctl.tick()

        _thread = threading.Thread(target=_loop, name="rsdl-elastic", daemon=True)
        _thread.start()


def maybe_start(ctx=None) -> bool:
    """Start when ``RSDL_ELASTIC`` asks for it and metrics are on (the
    loop's inputs are the metrics plane's folds: without them it would
    guess); else log why not and return False."""
    if not enabled():
        return False
    if not _metrics.enabled():
        logging.getLogger(__name__).warning(
            "%s=%s requested but RSDL_METRICS is off: the elastic loop needs the decision planes' signals; "
            "not starting", ENV_ELASTIC, mode())
        return False
    start(ctx)
    return True


def stop() -> None:
    """Stop the loop and join its thread (the session's end, tests)."""
    global _thread, _stop_event, _controller
    with _lock:
        thread, _thread = _thread, None
        stop_event, _stop_event = _stop_event, None
        _controller = None
    if stop_event is not None:
        stop_event.set()
    if thread is not None:
        thread.join(timeout=5.0)


def summary() -> Dict[str, Any]:
    """The controller's totals (empty when none ran in this process)."""
    ctl = _controller
    return ctl.summary() if ctl is not None else {}

"""The port's multi-host cluster plane, against the JAX package's.

* The scheduler's units on fake in-process agents, each scenario run on
  the port's ``ClusterScheduler`` and the JAX package's with the same
  fakes and held to the same outcome: the locality choice, the death
  confirmation, the ping ladder, dropping an agent, every agent dead; the
  registry's sweep of a departed host's names.
* ``StoreServer.fetch`` and ``fetch_vec``: the same bytes as the JAX
  package's ``StoreServer.fetch`` for the same columns and windows (the
  segment format is the same in both).
* Striped fetches over a real store server on authenticated loopback TCP:
  2, 3, 4 and 16 streams and a row window, byte-identical to the port's
  own single-stream fetch (the JAX package's striped fetch cannot serve
  as the reference: its actor host calls ``sendmsg`` on the event loop's
  ``TransportSocket``, which Python 3.12 no longer has, so its every
  vectored reply drops the connection); a corrupt stripe and a wrong token
  raise the retry-safe errors.
* One two-host run on loopback: a head and a host joined with ``python -m
  ...runtime.cluster join``, each with its own shared-memory and spill
  directories, rank 0 on the head and rank 1 in a process of the joined
  host's session, both with one audit spool. Each epoch's per-rank key
  stream must equal the JAX package's single-host ``shuffle()`` stream for
  the same seed, bytes must cross hosts, both agents must run tasks, the
  reduces must take the overlapped path (``scatter`` calls), and the
  audit's verdicts must equal those of the same run on one host. Streams
  and bytes are compared exactly; the source entropies, sums whose order
  follows the spool's record order, within 1e-12.
"""

import concurrent.futures
import importlib
import json
import mmap
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu.runtime import cluster as jax_cluster
from ray_shuffling_data_loader_tpu.runtime import store as jax_store
from ray_shuffling_data_loader_tpu.runtime.actor import ActorDiedError as JaxActorDiedError
from ray_shuffling_data_loader_tpu_torch.runtime import cluster as port_cluster
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store
from ray_shuffling_data_loader_tpu_torch.runtime import transport
from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorDiedError, spawn_actor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPERS = os.path.join(REPO, "tests", "torch_port_helpers.py")

# (cluster module, store module, its ActorDiedError) of each package.
IMPLS = {
    "port": (port_cluster, port_store, ActorDiedError),
    "jax": (jax_cluster, jax_store, JaxActorDiedError),
}


def _both(scenario):
    """``scenario(cluster, store, died)`` for each package; both outcomes,
    which must be equal."""
    got = {name: scenario(*mods) for name, mods in IMPLS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# -- the scheduler's units ------------------------------------------------------------


class _Agent:
    def __init__(self, name):
        self.address = ("tcp", name, 1)


def test_locality_choice_matches_jax(monkeypatch):
    """The host owning the most input rows (windows) or bytes (whole
    segments) wins; no owners, an unknown owner or RSDL_DISABLE_LOCALITY
    give no preference."""

    def scenario(cluster, store, died):
        a, b = _Agent("hostA"), _Agent("hostB")
        sched = cluster.ClusterScheduler([a, b], {("tcp", "hostA", 9): a, ("tcp", "hostB", 9): b})
        ref = store.ObjectRef
        names = {id(a): "a", id(b): "b", id(None): None}
        try:
            refs = [ref("x", 100, owner=("tcp", "hostA", 9), rows=(0, 10)),
                    ref("y", 100, owner=("tcp", "hostB", 9), rows=(0, 90))]
            out = [names[id(sched._locality_agent(refs))],
                   names[id(sched._locality_agent([ref("z", 10_000, owner=("tcp", "hostA", 9))]))],
                   names[id(sched._locality_agent([ref("w", 5)]))],
                   names[id(sched._locality_agent([ref("v", 5, owner=("tcp", "gone", 9))]))]]
            # A draining host is not preferred.
            sched.retire_agent(b)
            out.append(names[id(sched._locality_agent(refs))])
            sched.add_agent(b)
            monkeypatch.setenv("RSDL_DISABLE_LOCALITY", "1")
            out.append(names[id(sched._locality_agent(refs))])
            monkeypatch.delenv("RSDL_DISABLE_LOCALITY")
            return out
        finally:
            sched.shutdown()
            cluster.reset_membership()

    assert _both(scenario) == ["b", "a", None, None, None, None]


def test_death_is_confirmed_before_eviction_as_jax():
    """A failed call to an agent that answers a ping is retried, not
    evicted; an agent that answers none is dropped."""

    def scenario(cluster, store, died):
        class Flaky:
            address = ("tcp", "flaky", 1)

            def __init__(self):
                self.calls = 0

            def call(self, method, *args):
                self.calls += 1
                if self.calls == 1:
                    raise died("transient reset")
                return "ok"

            def ping(self, timeout=None):
                return True

        class Dead:
            address = ("tcp", "dead", 1)

            def call(self, method, *args):
                raise died("down")

            def ping(self, timeout=None):
                return False

        flaky, dead = Flaky(), Dead()
        sched = cluster.ClusterScheduler([flaky, dead])
        try:
            first = sched._submit_once(flaky, None, (), {})
            second = sched._submit_once(dead, None, (), {})
            return first, second, sorted(sched.agent_addresses), flaky.calls
        finally:
            sched.shutdown()

    first, second, live, calls = _both(scenario)
    assert first == (True, "ok") and second == (False, None) and calls == 2
    assert live == [("tcp", "flaky", 1)]


def test_ping_ladder_escalates_as_jax():
    """A loaded host that answers only a 10 s ping is kept: the ladder
    tries 5 s, then 10 s, before any eviction."""

    def scenario(cluster, store, died):
        class Loaded:
            address = ("tcp", "loaded", 1)

            def __init__(self):
                self.calls = 0
                self.pings = []

            def call(self, method, *args):
                self.calls += 1
                if self.calls == 1:
                    raise died("transient reset")
                return "ok"

            def ping(self, timeout=None):
                self.pings.append(timeout)
                return timeout is not None and timeout >= 10.0

        agent = Loaded()
        sched = cluster.ClusterScheduler([agent])
        try:
            return sched._submit_once(agent, None, (), {}), agent.pings, sorted(sched.agent_addresses)
        finally:
            sched.shutdown()

    result, pings, live = _both(scenario)
    assert result == (True, "ok") and pings == [5.0, 10.0] and live == [("tcp", "loaded", 1)]


def test_drop_agent_as_jax():
    """An agent leaves the rotation once; the eviction callback fires once
    with it, and a callback that raises does not break the scheduler."""

    def scenario(cluster, store, died):
        a, b = _Agent("a"), _Agent("b")
        sched = cluster.ClusterScheduler([a, b])
        try:
            evicted = []
            sched.on_agent_dead = lambda agent: evicted.append(agent.address)
            sched._drop_agent(a)
            after_first = sorted(sched.agent_addresses)
            sched._drop_agent(a)

            def boom(agent):
                raise RuntimeError("registry unreachable")

            sched.on_agent_dead = boom
            sched._drop_agent(b)
            return evicted, after_first, sorted(sched.agent_addresses)
        finally:
            sched.shutdown()

    evicted, after_first, left = _both(scenario)
    assert evicted == [("tcp", "a", 1)] and after_first == [("tcp", "b", 1)] and left == []


def test_all_agents_dead_raises_as_jax():
    """With every agent dead a task fails with the ActorDiedError naming
    it, and the rotation is empty."""

    def scenario(cluster, store, died):
        class Dead:
            def __init__(self, name):
                self.address = ("tcp", name, 1)

            def call(self, method, *args):
                raise died("down")

            def ping(self, timeout=None):
                return False

        sched = cluster.ClusterScheduler([Dead("d1"), Dead("d2")])
        try:
            fut = sched.submit(lambda: None)
            with pytest.raises(died, match="every cluster host agent has died"):
                fut.result(timeout=60)
            return sorted(sched.agent_addresses)
        finally:
            sched.shutdown()

    assert _both(scenario) == []


def test_retire_and_remove_agents_as_jax():
    """Draining agents take no new task (unless all drain); in-flight
    counts, agent rows and a removal's width match the JAX package's."""

    def scenario(cluster, store, died):
        class Echo:
            def __init__(self, name):
                self.address = ("tcp", name, 1)
                self.calls = 0

            def call(self, method, *args):
                self.calls += 1
                return self.address[1]

            def ping(self, timeout=None):
                return True

        a, b = Echo("a"), Echo("b")
        sched = cluster.ClusterScheduler([a], width=2)
        try:
            sched.add_agent(b, store_address=("tcp", "b", 9), num_workers=3)
            sched.retire_agent(a)
            placed = [sched.submit(lambda: None).result(timeout=30) for _ in range(4)]
            rows = sched.agent_rows()
            removed = sched.remove_agent(b)
            return placed, rows, removed, sched.width, sched.in_flight_on(a), sorted(sched.agent_addresses)
        finally:
            sched.shutdown()
            cluster.reset_membership()

    placed, rows, removed, width, inflight, live = _both(scenario)
    assert placed == ["b"] * 4 and removed and width == 2 and inflight == 0 and live == [("tcp", "a", 1)]
    assert [r["draining"] for r in rows] == [True, False]


def test_registry_sweeps_a_departed_hosts_names_as_jax():
    def scenario(cluster, store, died):
        reg = cluster.ClusterRegistry()
        reg.register_host("h1", ("tcp", "10.0.0.1", 700), ("tcp", "10.0.0.1", 701), 2)
        reg.register_host("h2", ("tcp", "10.0.0.2", 700), ("tcp", "10.0.0.2", 701), 2)
        reg.register_actor("q1", ("tcp", "10.0.0.1", 710), 11, host_id="h1")
        reg.register_actor("q2", ("tcp", "10.0.0.2", 710), 12, host_id="h2")
        reg.register_actor("legacy-agent", ("tcp", "10.0.0.1", 700), 13)
        reg.register_actor("same-ip-other", ("tcp", "10.0.0.1", 999), 14)
        with pytest.raises(ValueError):
            reg.register_actor("q1", ("tcp", "x", 1), 1)
        reg.unregister_host("h1")
        reg.unregister_host("h1")  # an unknown host: a no-op
        return sorted(n for n in ("q1", "q2", "legacy-agent", "same-ip-other") if reg.lookup_actor(n)), sorted(
            reg.hosts())

    assert _both(scenario) == (["q2", "same-ip-other"], ["h2"])


def test_cluster_address_round_trip():
    for mod in (port_cluster, jax_cluster):
        assert mod.parse_cluster_address("tcp://10.1.2.3:4567/abc") == ("10.1.2.3", 4567, "abc")
        assert mod.parse_cluster_address("tcp://h:1") == ("h", 1, None)
        assert mod.format_cluster_address("h", 1, "t") == "tcp://h:1/t"
        with pytest.raises(ValueError):
            mod.parse_cluster_address("/tmp/rsdl-x")


# -- the store server's bytes ---------------------------------------------------------

rng = np.random.default_rng(7)
COLUMNS = {
    "a": rng.integers(0, 1 << 30, size=5000),
    "b": rng.random(5000).astype(np.float32),
    "c": rng.integers(0, 255, size=(5000, 3)).astype(np.uint8),
}
WINDOWS = [None, (0, 5000), (100, 900), (4999, 5000), (7, 7)]


def test_store_server_fetch_bytes_equal_jax(tmp_path):
    """For a segment of each package's store, the port's ``fetch`` of the
    whole segment and of row windows is the JAX package's, byte for byte,
    and its ``fetch_vec`` buffers join to the same bytes."""
    shm = str(tmp_path)
    refs = [port_store.ObjectStore("ps", shm_dir=shm).put_columns(COLUMNS),
            jax_store.ObjectStore("js", shm_dir=shm).put_columns(COLUMNS)]
    port_srv, jax_srv = port_cluster.StoreServer(shm), jax_cluster.StoreServer(shm)
    for ref in refs:
        for rows in WINDOWS:
            want = jax_srv.fetch(ref.object_id, rows)
            assert port_srv.fetch(ref.object_id, rows) == want, rows
            oob = port_srv.fetch_vec(ref.object_id, rows)
            assert oob.meta == {"nbytes": len(want)}
            assert b"".join(bytes(memoryview(b).cast("B")) for b in oob.buffers) == want, rows
    assert port_srv.fetch_stats() == {"count": 20, "bytes": 2 * jax_srv.fetch_stats()["bytes"]}
    with pytest.raises(ValueError):
        port_srv.fetch("../etc")


def test_store_server_segment_inventory(tmp_path):
    """``list_segments``, ``put_segment`` (the existing copy wins),
    ``exists`` and ``free``."""
    shm = str(tmp_path)
    store = port_store.ObjectStore("inv", shm_dir=shm)
    ref = store.put_columns({"k": np.arange(10)})
    srv = port_cluster.StoreServer(shm)
    assert srv.list_segments("inv-") == [(ref.object_id, ref.nbytes)]
    data = srv.fetch(ref.object_id)
    assert not srv.put_segment(ref.object_id, b"other")
    assert srv.put_segment("inv-adopted", data) and srv.fetch("inv-adopted") == data
    srv.free(ref.object_id)
    assert not srv.exists(ref.object_id) and srv.exists("inv-adopted")


# -- striped fetches over authenticated TCP ---------------------------------------------------


@pytest.fixture(scope="module")
def store_server(tmp_path_factory):
    """A store server actor on authenticated loopback TCP and a store
    holding one segment of several columns in its directory."""
    token_prev = os.environ.get("RSDL_CLUSTER_TOKEN")
    os.environ["RSDL_CLUSTER_TOKEN"] = "striping-test-secret"
    shm = str(tmp_path_factory.mktemp("stripe-shm"))
    rt = str(tmp_path_factory.mktemp("stripe-rt"))
    store = port_store.ObjectStore("stripesess", shm_dir=shm)
    ref = store.put_columns({"a": rng.integers(0, 1 << 30, size=50_000), "b": rng.random(50_000).astype(np.float32)})
    handle = spawn_actor(port_cluster.StoreServer, shm, runtime_dir=rt, host="127.0.0.1")
    try:
        yield handle, store, ref, shm
    finally:
        handle.terminate()
        store.cleanup()
        if token_prev is None:
            os.environ.pop("RSDL_CLUSTER_TOKEN", None)
        else:
            os.environ["RSDL_CLUSTER_TOKEN"] = token_prev


def _striped_to_file(handle, object_id, rows, shm, n_streams, pool):
    """:func:`fetch_vec_striped` into a mapped file, as the store fetches;
    the file's bytes."""
    dst = os.path.join(shm, f"dst-{n_streams}-{threading.get_ident()}")
    state = {}

    def alloc(n):
        fd = os.open(dst, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, max(n, 1))
            state["mm"] = mmap.mmap(fd, max(n, 1))
        finally:
            os.close(fd)
        return state["mm"]

    try:
        port_cluster.fetch_vec_striped(handle, object_id, rows, alloc, n_streams, pool)
        return bytes(state["mm"])
    finally:
        if "mm" in state:
            state["mm"].close()
        os.unlink(dst)


@pytest.mark.parametrize("rows", [None, (100, 9000)], ids=["segment", "row_window"])
@pytest.mark.parametrize("streams", [2, 3, 4, 16])
def test_striped_fetch_byte_identical(store_server, streams, rows):
    handle, _, ref, shm = store_server
    single = handle.call("fetch", ref.object_id, rows)
    with concurrent.futures.ThreadPoolExecutor(max_workers=streams) as pool:
        assert _striped_to_file(handle, ref.object_id, rows, shm, streams, pool) == single


def test_striped_fetch_more_streams_than_bytes(store_server):
    """A segment smaller than the stream count leaves stripes empty."""
    handle, store, _, shm = store_server
    tiny = store.put_columns({"t": np.arange(2, dtype=np.int8)})
    single = handle.call("fetch", tiny.object_id, None)
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
        assert _striped_to_file(handle, tiny.object_id, None, shm, len(single) + 3, pool) == single
    store.free(tiny)


def test_single_stream_vectored_fetch(store_server):
    """``call_vectored("fetch_vec")`` lands the segment in the caller's
    buffer: the plain fetch's bytes."""
    handle, _, ref, _ = store_server
    for rows in (None, (100, 9000)):
        got = {}

        def alloc(n):
            got["buf"] = bytearray(n)
            return got["buf"]

        meta, payload = handle.call_vectored("fetch_vec", ref.object_id, rows, into=alloc)
        payload.release()
        assert meta == {"nbytes": len(got["buf"])}
        assert bytes(got["buf"]) == handle.call("fetch", ref.object_id, rows)


def test_striped_fetch_corrupt_stripe_raises_retry_safe(store_server):
    """A stripe whose meta does not fit its payload fails as a broken
    connection: ``ConnectionError`` or ``ActorDiedError``."""
    handle, _, ref, _ = store_server

    class Tampered:
        def call_vectored(self, method, object_id, rows, stripe, into):
            def tampered(nbytes, meta):
                if stripe[0] == 1:
                    meta = dict(meta, nbytes=int(meta["nbytes"]) + 64)
                return into(nbytes, meta)

            tampered.wants_meta = True
            return handle.call_vectored(method, object_id, rows, stripe=stripe, into=tampered)

    state = {}

    def alloc(n):
        state["mm"] = mmap.mmap(-1, max(n, 1))
        return state["mm"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises((ActorDiedError, ConnectionError)):
            port_cluster.fetch_vec_striped(Tampered(), ref.object_id, None, alloc, 2, pool)
    if "mm" in state:
        state["mm"].close()
    # The server still serves: only the tampered connection was dropped.
    assert handle.call("fetch_stats")["count"] > 0


def test_striped_fetch_wrong_token_raises_retry_safe(store_server, monkeypatch):
    """A wrong token: the server drops the connection before reading a
    frame, and the fetch raises ``ActorDiedError``."""
    handle, _, ref, _ = store_server
    monkeypatch.setenv("RSDL_CLUSTER_TOKEN", "WRONG-secret")
    fresh = type(handle)(handle.address)  # new connections, with the wrong token
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises(ActorDiedError):
            port_cluster.fetch_vec_striped(fresh, ref.object_id, None, lambda n: bytearray(n), 2, pool)
    with pytest.raises(ActorDiedError):
        fresh.call("fetch_stats")


# -- two hosts on loopback ----------------------------------------------------------------

ROWS, FILES, REDUCERS, SEED, EPOCHS, BATCH = 4000, 4, 4, 11, 2, 500
# Verdict fields that follow the consumed side: a rank in a process of its
# own spools its records when it exits, which may be after the driver's
# reconcile (in either package), so they are not compared.
CONSUMED_FIELDS = ("rows_consumed", "consumed_digest")
ENTROPY_FIELDS = ("source_entropy_mean", "source_entropy_min")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The dataset, and the JAX package's single-host stream of it: per
    epoch, each rank's keys in delivery order."""
    from ray_shuffling_data_loader_tpu import runtime as jax_runtime
    from ray_shuffling_data_loader_tpu.data_generation import generate_data

    jax_shuffle = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")
    fresh = not jax_runtime.is_initialized()
    jax_runtime.init(num_workers=2)
    files, _ = generate_data(ROWS, FILES, 1, 0.0, str(tmp_path_factory.mktemp("cluster-data")))
    keys = {}

    class Keys:
        def consume(self, rank, epoch, batches):
            store = jax_runtime.get_context().store
            for ref in batches:
                keys.setdefault((epoch, rank), []).append(np.array(store.get_columns(ref)["key"]))
            store.free(batches)

        def producer_done(self, rank, epoch):
            pass

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            pass

    try:
        jax_shuffle.shuffle(files, Keys(), EPOCHS, REDUCERS, 2, seed=SEED)
    finally:
        if fresh:
            jax_runtime.shutdown()
    return files, {k: np.concatenate(v) for k, v in keys.items()}


def _run_hosts(work, files, mode, env):
    """One run of ``cluster_head_main`` (and, for a cluster, a joined
    host); returns the result, each rank's keys and the directories of the
    hosts' segments."""
    os.makedirs(work)
    dirs = {h: {"RSDL_SHM_DIR": os.path.join(work, f"shm-{h}"), "RSDL_SPILL_DIR": os.path.join(work, f"spill-{h}")}
            for h in ("head", "joined")}
    spec = {
        "cluster_test": True, "mode": mode, "files": files, "epochs": EPOCHS, "reducers": REDUCERS, "seed": SEED,
        "batch_size": BATCH, "queue": f"q-{mode}", "addr_file": os.path.join(work, "address"),
        "rank0_out": os.path.join(work, "rank0.npz"), "rank1_out": os.path.join(work, "rank1.npz"),
        "result": os.path.join(work, "result.json"), "spec_path": os.path.join(work, "spec.json"),
        "rank1_shm": dirs["joined"]["RSDL_SHM_DIR"], "rank1_spill": dirs["joined"]["RSDL_SPILL_DIR"],
    }
    with open(spec["spec_path"], "w") as f:
        json.dump(spec, f)
    procs = {}
    with open(os.path.join(work, "head.log"), "w") as hl, open(os.path.join(work, "joined.log"), "w") as jl:
        procs["head"] = subprocess.Popen([sys.executable, HELPERS, spec["spec_path"], "head"], stdout=hl,
                                         stderr=subprocess.STDOUT, env={**env, **dirs["head"]})
        try:
            if mode == "cluster":
                deadline = time.monotonic() + 60
                while not os.path.exists(spec["addr_file"]):
                    assert procs["head"].poll() is None and time.monotonic() < deadline, "the head did not start"
                    time.sleep(0.05)
                with open(spec["addr_file"]) as f:
                    address = f.read()
                procs["joined"] = subprocess.Popen(
                    [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.runtime.cluster", "join", address,
                     "--num-workers", "2"], stdout=jl, stderr=subprocess.STDOUT, env={**env, **dirs["joined"]})
            for name, proc in procs.items():
                # The joined host leaves once the head's registry is gone.
                assert proc.wait(timeout=150) == 0, (name, open(os.path.join(work, f"{name}.log")).read())
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
    with open(spec["result"]) as f:
        result = json.load(f)
    ranks = [dict(np.load(spec[f"rank{r}_out"])) for r in (0, 1)]
    return result, ranks, dirs


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory, dataset):
    """The cluster run and the one-host run, side by side, each with its
    own audit spool."""
    files, _ = dataset
    root = str(tmp_path_factory.mktemp("two-hosts"))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    env.update(RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_AUDIT="1",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
    runs = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {mode: pool.submit(_run_hosts, os.path.join(root, mode), files, mode,
                                  {**env, "RSDL_AUDIT_DIR": os.path.join(root, mode, "spool")})
                for mode in ("cluster", "single")}
        for mode, fut in futs.items():
            runs[mode] = fut.result()
    yield runs
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("mode", ["cluster", "single"])
def test_two_hosts_deliver_the_jax_single_host_stream(two_hosts, dataset, mode):
    """Every epoch, each rank's keys as its ``ShufflingDataset`` yielded
    them equal the rank's stream of the JAX package's ``shuffle()`` on one
    host with the same seed, bit for bit."""
    _, want = dataset
    _, ranks, _ = two_hosts[mode]
    for epoch in range(EPOCHS):
        for rank in (0, 1):
            got = ranks[rank][f"epoch{epoch}"]
            assert got.dtype == want[(epoch, rank)].dtype
            np.testing.assert_array_equal(got, want[(epoch, rank)], err_msg=f"{mode} epoch {epoch} rank {rank}")


def test_two_hosts_share_the_work(two_hosts):
    """Both agents ran tasks, the store servers served bytes across hosts,
    the reduces that fetched took the overlapped path (the permutation's
    inversion and the windows' placement are ``scatter`` calls), rank 1
    found the queue through the registry, an actor placed on the joined
    host (``spawn_actor(host_id=)``) runs in its session and is found by
    name, and one host alone never overlaps."""
    result, _, _ = two_hosts["cluster"]
    assert len(result["agents"]) == 2 and all(n > 0 for n in result["agents"].values()), result["agents"]
    assert sum(result["served"].values()) > 0, result["served"]
    assert result["native_calls"]["scatter"] > 0 and result["queue_in_registry"]
    probe = result["probe"]
    assert probe["runtime_dir"] == probe["want"] and probe["named"], probe
    single, _, _ = two_hosts["single"]
    assert single["native_calls"]["scatter"] == 0 and single["native_calls"]["take_multi"] > 0


def test_two_hosts_audit_as_one_host(two_hosts):
    """The shared spool reconciles every epoch ``ok`` over both hosts'
    maps and reduces and both ranks' deliveries, with the digests of the
    same run on one host."""
    verdicts = {mode: two_hosts[mode][0]["verdicts"] for mode in ("cluster", "single")}
    assert [v["epoch"] for v in verdicts["cluster"]] == list(range(EPOCHS))
    for got, want in zip(verdicts["cluster"], verdicts["single"]):
        assert got["ok"] is True and not got["mismatch"], got
        assert got["rows_mapped"] == got["rows_reduced"] == got["rows_delivered"] == ROWS
        for key in want:
            if key in ENTROPY_FIELDS:
                assert got[key] == pytest.approx(want[key], abs=1e-12), key
            elif key not in CONSUMED_FIELDS:
                assert got[key] == want[key], key


def test_two_hosts_leave_no_segment(two_hosts):
    """After shutdown neither host's shared-memory or spill directory
    holds a segment."""
    for mode in ("cluster", "single"):
        for dirs in two_hosts[mode][2].values():
            for d in dirs.values():
                assert not os.path.isdir(d) or not os.listdir(d), (mode, d, os.listdir(d))

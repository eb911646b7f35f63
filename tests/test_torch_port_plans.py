"""The block plan family (``RSDL_SHUFFLE_PLAN=block[:G]``) and the
selective schedule (``RSDL_SELECTIVE_READS``) on the port, against the
JAX package: the plan's parsing, group-aligned assignments and their
granularity, disjoint row-group selections, the ``auto`` gate, the
row-group decode, the delivered ``key`` streams of both packages under
``block:1`` and ``block:2``, materialized and selective, and a journaled
run killed under ``block:2`` and resumed with ``redeliver``.

The port's pool is spawned before any test sets a plan: its workers'
environments name none, so every stream here also shows that ``shuffle()``
hands its resolved plan to the tasks."""

import collections
import glob
import importlib
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import native as jax_native
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu import utils as jax_utils
from ray_shuffling_data_loader_tpu.runtime.store import logical_columns as jax_logical_columns
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store

# The JAX package's root exports its ``shuffle`` function under the module's name.
jax_sh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS, SEED = 3000, 3, 5, 4, 17
CHILD_DEADLINE_S = 90
PLAN_ENV = ("RSDL_SHUFFLE_PLAN", "RSDL_SELECTIVE_READS", "RSDL_INDEX_SHUFFLE", "RSDL_DECODE_ROWGROUPS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in PLAN_ENV + ("RSDL_PLAN", "RSDL_DISABLE_NATIVE"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Skewed row groups (odd sizes), as the JAX package's plan tests use."""
    port_runtime.init(num_workers=2)
    names, _ = generate_data(NUM_ROWS, NUM_FILES, ROW_GROUPS, 0.5, str(tmp_path_factory.mktemp("plans")))
    yield names
    port_runtime.shutdown()


class _Collect(sh.BatchConsumer):
    """Every delivered ``key``, per ``(epoch, rank)``, packed outputs
    unpacked."""

    def __init__(self):
        self.keys = collections.defaultdict(list)
        self.done = collections.defaultdict(bool)

    def consume(self, rank, epoch, batches):
        store = port_runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            if port_store.is_device_batch(cb):
                keys = np.concatenate([v["key"] for v in port_store.iter_packed_batches(cb)])
            else:
                keys = cb["key"]
            self.keys[(epoch, rank)].extend(np.asarray(keys).tolist())
        store.free(batches)

    def producer_done(self, rank, epoch):
        self.done[(epoch, rank)] = True

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


class _JaxCollect(jax_sh.BatchConsumer):
    def __init__(self):
        self.keys = collections.defaultdict(list)

    def consume(self, rank, epoch, batches):
        store = jax_runtime.get_context().store
        for ref in batches:
            self.keys[(epoch, rank)].extend(np.asarray(jax_logical_columns(store.get_columns(ref))["key"]).tolist())
            store.free(ref)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def _port_run(files, num_epochs=2, num_trainers=2, **kwargs):
    consumer, log, stats = _Collect(), [], {}
    sh.shuffle(list(files), consumer, num_epochs, NUM_REDUCERS, num_trainers, seed=SEED, schedule_log=log,
               stats=stats, **kwargs)
    return consumer, [s for _, s in log], stats


# -- the plan family ---------------------------------------------------------------


def test_shuffle_plan_spec_parsing(monkeypatch):
    """Parsed as the JAX package parses it: rowwise by default, block[:G],
    and a ValueError naming the variable on anything malformed."""
    for env, spec, label in (("", ("rowwise", 0), "rowwise"), ("rowwise", ("rowwise", 0), "rowwise"),
                             ("block", ("block", 1), "block:1"), ("block:3", ("block", 3), "block:3")):
        monkeypatch.setenv("RSDL_SHUFFLE_PLAN", env)
        assert sh.shuffle_plan_spec() == jax_utils.shuffle_plan_spec() == spec
        assert sh.shuffle_plan_label() == jax_utils.shuffle_plan_label() == label
        assert sh._label_of_plan(spec) == jax_sh._label_of_plan(spec) == label
        assert sh.plan_is_prunable(spec) == jax_sh.plan_is_prunable(spec) == (spec[0] == "block")
    for bad in ("block:0", "block:-1", "block:x", "banana"):
        monkeypatch.setenv("RSDL_SHUFFLE_PLAN", bad)
        for parse in (sh.shuffle_plan_spec, jax_utils.shuffle_plan_spec):
            with pytest.raises(ValueError, match="RSDL_SHUFFLE_PLAN"):
                parse()


def test_block_assignment_group_aligned(files):
    """Every row of a row group goes to one reducer, the JAX package's
    reducer; the draw is fixed per (seed, epoch, file) and re-dealt per
    epoch; a missing file name or a footer that disagrees raises."""
    plan = ("block", 1)
    for i, fname in enumerate(files):
        sizes = sh.file_row_group_sizes(fname)
        assert sizes == jax_sh.file_row_group_sizes(fname) and len(sizes) == ROW_GROUPS
        n = sum(sizes)
        a1 = sh._file_assignment(3, 1, i, n, 4, fname, plan)
        np.testing.assert_array_equal(a1, jax_sh._file_assignment(3, 1, i, n, 4, fname, plan))
        np.testing.assert_array_equal(a1, sh._file_assignment(3, 1, i, n, 4, fname, plan))
        off = 0
        for s in sizes:
            assert len(set(a1[off:off + s].tolist())) == 1
            off += s
    fname = files[0]
    n = sum(sh.file_row_group_sizes(fname))
    assert not np.array_equal(sh._file_assignment(3, 1, 0, n, 4, fname, plan),
                              sh._file_assignment(3, 2, 0, n, 4, fname, plan))
    # Rowwise ignores the footer and equals the JAX package's draw.
    np.testing.assert_array_equal(sh._file_assignment(3, 1, 0, n, 4, fname, ("rowwise", 0)),
                                  jax_sh._file_assignment(3, 1, 0, n, 4, fname, ("rowwise", 0)))
    with pytest.raises(ValueError, match="filename"):
        sh._file_assignment(3, 1, 0, n, 4, None, plan)
    with pytest.raises(ValueError, match="footer"):
        sh._file_assignment(3, 1, 0, n + 1, 4, fname, plan)


@pytest.mark.parametrize("granularity", [1, 2, 3])
def test_block_granularity_blocks_groups(files, granularity):
    """block:G deals runs of G consecutive row groups to one reducer, as
    the JAX package deals them."""
    sizes = sh.file_row_group_sizes(files[0])
    for epoch in range(3):
        owners = sh._group_owners(5, epoch, 0, sizes, 3, granularity)
        np.testing.assert_array_equal(owners, jax_sh._group_owners(5, epoch, 0, sizes, 3, granularity))
        assert len(owners) == len(sizes)
        for b in range(0, len(sizes), granularity):
            assert len(set(owners[b:b + granularity].tolist())) == 1
    assert len(sh._group_owners(5, 0, 0, [], 3, granularity)) == 0


def test_block_selections_disjoint_cover_once(files):
    """Under a block plan the reducers' row-group selections are disjoint
    and cover every group once, block counts within one of each other;
    selections and positions equal the JAX package's."""
    plan = ("block", 1)
    for i, fname in enumerate(files):
        sels = []
        for r in range(NUM_REDUCERS):
            gsel, pos = sh.selective_file_selection(fname, i, r, NUM_REDUCERS, 0, 9, plan)
            jsel, jpos = jax_sh.selective_file_selection(fname, i, r, NUM_REDUCERS, 0, 9, plan)
            np.testing.assert_array_equal(gsel, jsel)
            np.testing.assert_array_equal(pos, jpos)
            sels.append(gsel)
        allg = np.concatenate(sels)
        assert len(allg) == len(np.unique(allg)) == ROW_GROUPS
        lens = sorted(len(s) for s in sels)
        assert lens[-1] - lens[0] <= 1


@pytest.mark.parametrize("plan", ["", "block", "block:3"])
@pytest.mark.parametrize("mode", ["", "off", "auto", "on", "1", "bogus"])
def test_selective_auto_gate(monkeypatch, mode, plan):
    """The decision and its reason are the JAX package's: ``auto`` engages
    under a block plan only and says why it declines under rowwise; ``on``
    engages under any plan; anything else is off."""
    monkeypatch.setenv("RSDL_SELECTIVE_READS", mode)
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", plan)
    got = sh.selective_reads_decision()
    assert got == jax_sh.selective_reads_decision()
    assert got == sh.selective_reads_decision(sh.shuffle_plan_spec())
    engaged, reason = got
    if mode == "auto":
        assert engaged == bool(plan) and ("prunable" in reason if plan else "declined" in reason)
    else:
        assert engaged == (mode in ("on", "1"))


def test_selective_auto_declines_to_materialized(files, monkeypatch):
    monkeypatch.setenv("RSDL_SELECTIVE_READS", "auto")
    consumer, schedules, stats = _port_run(files, num_epochs=1, num_trainers=1, cache_decoded=False)
    assert schedules == ["mapreduce"] and "declined" in stats["selective_reads"]
    assert sorted(consumer.keys[(0, 0)]) == list(range(NUM_ROWS))
    assert "selective_rowgroups" not in stats


# -- the row-group decode ------------------------------------------------------------


@pytest.mark.parametrize("threads", ["off", "2", "auto"])
def test_read_parquet_row_groups_match(files, monkeypatch, threads):
    """A selection of row groups decodes to the whole file's rows of those
    groups, bit for bit, single or striped over threads, as the JAX
    package's read does; an empty selection gives empty typed columns."""
    monkeypatch.setenv("RSDL_DECODE_ROWGROUPS", threads)
    n_threads = sh.decode_rowgroup_threads(2)
    assert n_threads == jax_utils.decode_rowgroup_threads(2)
    fname = files[1]
    whole = sh.read_parquet_columns(fname)
    offs = np.concatenate([[0], np.cumsum(sh.file_row_group_sizes(fname))])
    for sel in ([0, 1, 2, 3, 4], [3, 1], [2], []):
        got = sh.read_parquet_columns(fname, row_groups=sel, rowgroup_threads=n_threads)
        want = jax_sh.read_parquet_columns(fname, row_groups=sel, rowgroup_threads=n_threads)
        rows = np.concatenate([np.arange(offs[g], offs[g + 1]) for g in sorted(sel)] or [np.zeros(0, np.int64)])
        assert list(got.columns) == list(want.columns) == list(whole.columns)
        for k in whole.columns:
            assert got[k].dtype == want[k].dtype == whole[k].dtype
            assert got[k].tobytes() == want[k].tobytes() == whole[k][rows].tobytes()
    with pytest.raises(ValueError, match="not in"):
        sh.read_parquet_columns(fname, columns=["key", "nope"], row_groups=[0])


# -- streams ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("selective", ["off", "auto"])
@pytest.mark.parametrize("plan", ["block:1", "block:2"])
def test_key_streams_match_jax(files, local_runtime, monkeypatch, plan, selective, packed):
    """The same files and seed through the JAX package's ``shuffle()`` and
    the port's: every ``(epoch, rank)`` key stream is equal, narrowed and
    packed into a staging layout or not; a selective run decodes every
    row group of every file exactly once an epoch."""
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", plan)
    monkeypatch.setenv("RSDL_SELECTIVE_READS", selective)
    kwargs = dict(cache_decoded=False)
    if packed:
        kwargs.update(narrow_to_32=True, device_layout={"batch": 200, "columns": ["key", "labels"]})
    want = _JaxCollect()
    jax_sh.shuffle(list(files), want, 2, NUM_REDUCERS, 2, seed=SEED, **kwargs)
    got, schedules, stats = _port_run(files, **kwargs)
    assert schedules == (["selective"] * 2 if selective == "auto" else ["mapreduce"] * 2)
    assert stats["plan"] == plan
    assert dict(got.keys) == dict(want.keys)
    for epoch in range(2):
        keys = got.keys[(epoch, 0)] + got.keys[(epoch, 1)]
        assert sorted(keys) == list(range(NUM_ROWS))
        if selective == "auto":
            decoded = stats["selective_rowgroups"][epoch]
            assert sorted(map(tuple, decoded)) == [(i, g) for i in range(NUM_FILES) for g in range(ROW_GROUPS)]
    assert sum(stats["native_calls"].values()) > 0 and not any(stats["plain_calls"].values())
    assert port_runtime.store_stats().num_objects == 0


def test_block_streams_equal_across_schedules_and_native(files, monkeypatch):
    """Under block:2 the materialized, selective and index schedules, and
    the plain host passes, deliver one stream; rowwise is another."""
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "block:2")
    base, _, _ = _port_run(files, cache_decoded=False)
    monkeypatch.setenv("RSDL_SELECTIVE_READS", "on")
    selective, schedules, _ = _port_run(files, cache_decoded=False)
    assert schedules == ["selective"] * 2
    monkeypatch.setenv("RSDL_SELECTIVE_READS", "off")
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", "on")
    index, schedules, _ = _port_run(files, cache_decoded=True)
    assert schedules == ["mapreduce", "index"]
    # The JAX package reads the same variable once per process, at its
    # first kernel call: keep its kernels on for later tests here.
    assert jax_native.native_available()
    monkeypatch.setenv("RSDL_DISABLE_NATIVE", "1")
    plain, _, stats = _port_run(files, cache_decoded=True)
    assert not any(stats["native_calls"].values()) and stats["plain_calls"]["take_multi"] > 0
    assert dict(selective.keys) == dict(base.keys) == dict(index.keys) == dict(plain.keys)
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "rowwise")
    rowwise, _, _ = _port_run(files, cache_decoded=False)
    assert dict(rowwise.keys) != dict(base.keys)


# -- a killed run under block:2, resumed with redeliver ------------------------------------

_CHILD = r"""
import json, os, signal, sys, threading, time
sys.path.insert(0, os.environ["PLANS_REPO"])
import numpy as np
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

mode, out_dir = os.environ["PLANS_MODE"], os.environ["PLANS_OUT"]
reducers = int(os.environ["PLANS_REDUCERS"])


def watch_journal():
    # SIGKILL ourselves once one epoch is delivered whole and another in part.
    jdir = os.environ["RSDL_JOURNAL"]
    while True:
        time.sleep(0.01)
        for path in os.listdir(jdir):
            if not path.endswith(".ndjson"):
                # The run's header is written under a hidden .tmp name and
                # renamed: opening that name can race the rename and kill
                # this thread, and the victim would then never be killed.
                continue
            cursors = {}
            with open(os.path.join(jdir, path)) as f:
                for line in f:
                    if line.endswith("\n"):
                        rec = json.loads(line)
                        if rec.get("kind") == "deliver":
                            e = int(rec["epoch"])
                            cursors[e] = max(cursors.get(e, 0), int(rec["reducer"]) + 1)
            if any(c >= reducers for c in cursors.values()) and any(0 < c < reducers for c in cursors.values()):
                os.kill(os.getpid(), signal.SIGKILL)


class Record(BatchConsumer):
    def consume(self, rank, epoch, batches, seq=None):
        store = runtime.get_context().store
        keys = np.concatenate([store.get_columns(ref)["key"] for ref in batches])
        store.free(batches)
        n = len([f for f in os.listdir(out_dir) if f.startswith(f"{mode}-{epoch}-")])
        np.save(os.path.join(out_dir, f"{mode}-{epoch}-{n:03d}.npy"), keys)
        if mode == "victim":
            time.sleep(0.1)

    def producer_done(self, rank, epoch): pass
    def wait_until_ready(self, epoch): pass
    def wait_until_all_epochs_done(self): pass


if __name__ == "__main__":
    runtime.init(num_workers=2)
    if mode == "victim":
        threading.Thread(target=watch_journal, daemon=True).start()
    stats = {}
    shuffle(json.loads(os.environ["PLANS_FILES"]), Record(), 3, reducers, 1, seed=7, stats=stats)
    print("RESULT " + json.dumps(stats.get("resume")), flush=True)
    runtime.shutdown()
"""


@pytest.mark.parametrize("selective", ["off", "auto"])
def test_redeliver_resume_under_block_plan(files, tmp_path, selective):
    """A journaled run under block:2 SIGKILLed with one epoch delivered and
    another in part; ``RSDL_RESUME=redeliver`` re-attaches what survives
    (a selective map's counts always do) and delivers the uninterrupted
    run's stream again, every epoch."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    out, journal = tmp_path / "out", tmp_path / "journal"
    out.mkdir()
    journal.mkdir()

    def child(mode, extra):
        env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
        env.update(PLANS_REPO=REPO, PLANS_MODE=mode, PLANS_OUT=str(out), PLANS_FILES=json.dumps(list(files)),
                   PLANS_REDUCERS=str(NUM_REDUCERS), RSDL_SHUFFLE_PLAN="block:2", RSDL_SELECTIVE_READS=selective,
                   RSDL_SHM_DIR=str(tmp_path / "shm"))
        env.update(extra)
        os.makedirs(env["RSDL_SHM_DIR"], exist_ok=True)
        return subprocess.run([sys.executable, str(script)], capture_output=True, text=True, env=env,
                              timeout=CHILD_DEADLINE_S, cwd=str(tmp_path))

    def stream(mode):
        return {e: np.concatenate([np.load(p) for p in sorted(glob.glob(str(out / f"{mode}-{e}-*.npy")))])
                for e in range(3)}

    control = child("control", {"RSDL_SHM_DIR": str(tmp_path / "shm-control")})
    assert control.returncode == 0, control.stderr
    victim = child("victim", {"RSDL_JOURNAL": str(journal)})
    assert victim.returncode == -signal.SIGKILL, victim.stderr
    (run,) = glob.glob(str(journal / "run-*.ndjson"))
    st = jmod.load_run(run)
    assert st.resumable() and st.identity["plan"] == "block:2"
    # Which of the materialized and index schedules ``auto`` takes depends
    # on the host's probe.
    schedules = {s.schedule for s in st.epochs.values()}
    assert schedules == {"selective"} if selective == "auto" else "selective" not in schedules
    resumed = child("resume", {"RSDL_JOURNAL": str(journal), "RSDL_RESUME": "redeliver"})
    assert resumed.returncode == 0, resumed.stderr
    counters = json.loads([ln for ln in resumed.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])
    assert counters["mode"] == "redeliver"
    if selective == "auto":
        # A selective map's journaled counts re-attach with no segment.
        assert counters["maps_reattached"] > 0
    want, got = stream("control"), stream("resume")
    for e in range(3):
        np.testing.assert_array_equal(got[e], want[e], err_msg=f"epoch {e}")
        assert sorted(got[e].tolist()) == list(range(NUM_ROWS))
    assert not [n for n in os.listdir(tmp_path / "shm") if n.startswith("rsdl-")]
